"""The embedding tables' lookups of a training step, forward and backward, in
four forms on a CUDA card, at the shapes a training step at crop 448 gives
them (one pose, 448 rows x 60 edges = 26,880 lookups a table, edge width
128): the spatial table (100 rows, four lookups summed) and the positional
table (66 rows, one lookup).

- `indexed`: w[idx] (+ ...), whose backward is the sorted scatter
  (`indexing_backward_kernel`);
- `index_select`: w.index_select(0, idx), whose backward adds atomically
  (index_add_), in any order;
- `embedding`: F.embedding, whose backward sorts the indices
  (embedding_dense_backward);
- `table_rows`: the port's form (features/sixd.table_rows), the gather
  forward with the gradient as one [V, M] x [M, E] GEMM of the index
  counts (K = M = 26,880 long).

For each: forward + backward time (CUDA events, median of 20 after a
warm-up; at these sizes the events see the host's launches too), the
backward's device time (torch.profiler, the kernels of 10 backward passes:
what a captured step pays), whether two backward passes give the same
gradient bit for bit, and the gradient's largest distance from a float64
reference.

    python3 scripts/torch_table_backward.py   # on a CUDA card, ~20 s
"""
from __future__ import annotations

import os
import statistics
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dfmdock_tpu_torch.features.sixd import table_rows  # noqa: E402

EDGES, WIDTH = 448 * 60, 128
TABLES = {"spatial": (100, (40, 24, 24, 12), (0, 40, 64, 88)), "positional": (66, (66,), (0,))}


def forms():
    def indexed(w, idx):
        out = w[idx[0]]
        for i in idx[1:]:
            out = out + w[i]
        return out

    def index_select(w, idx):
        out = w.index_select(0, idx[0])
        for i in idx[1:]:
            out = out + w.index_select(0, i)
        return out

    def embedding(w, idx):
        out = F.embedding(idx[0], w)
        for i in idx[1:]:
            out = out + F.embedding(i, w)
        return out

    return {"indexed": indexed, "index_select": index_select, "embedding": embedding,
            "table_rows": lambda w, idx: table_rows(w, *idx)}


def timed(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, calls=10):
    """Device time per call of `fn`: every kernel it launches, summed from
    a torch.profiler trace of `calls` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = lambda e: getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
    return sum(us(e) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / calls


def main():
    if not torch.cuda.is_available():
        print("torch_table_backward: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"# card: {smi}; torch {torch.__version__}")
    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    for table, (rows, sizes, offsets) in TABLES.items():
        w = torch.from_numpy(rng.randn(rows, WIDTH).astype(np.float32)).to(dev)
        idx = [torch.from_numpy(rng.randint(0, n, EDGES) + o).to(dev)
               for n, o in zip(sizes, offsets)]
        grad = torch.from_numpy(rng.randn(EDGES, WIDTH).astype(np.float32)).to(dev)
        ref = torch.zeros(rows, WIDTH, dtype=torch.float64, device=dev)
        for i in idx:
            ref.index_add_(0, i, grad.double())
        for name, fn in forms().items():
            wr = w.clone().requires_grad_(True)
            out = fn(wr, idx)
            if not torch.equal(out, forms()["indexed"](w, idx)):
                raise AssertionError(f"{table} {name}: the forward differs from w[idx]")

            def both():
                wr.grad = None
                fn(wr, idx).backward(grad)

            def backward():
                (torch.autograd.grad(out, wr, grad, retain_graph=True))

            ms, bwd_ms, bwd_dev = timed(both), timed(backward), device_ms(backward)
            g1 = torch.autograd.grad(out, wr, grad, retain_graph=True)[0]
            g2 = torch.autograd.grad(out, wr, grad, retain_graph=True)[0]
            err = float((g1.double() - ref).abs().max() / ref.abs().max())
            print(f"# {table} ({rows} rows, {len(idx)} lookup(s) of {EDGES}): {name:12s} "
                  f"forward+backward {ms:.4f} ms, backward {bwd_ms:.4f} ms (device "
                  f"{bwd_dev:.4f} ms), two backward "
                  f"passes {'bit-equal' if torch.equal(g1, g2) else 'differ'}, rel err vs "
                  f"float64 {err:.2e}")
    print(f"# card: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
