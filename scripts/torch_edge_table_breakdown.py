"""What sets the time of the port's edge_table and edge_bins kernels, on one
CUDA card.

    python3 scripts/torch_edge_table_breakdown.py [--save FILE | --compare FILE]

Both wrappers run on chip_smoke.py's seed-0 dock inputs (DB5 1AVX, P = 16
poses, N = 448, K = 60) and on the same poses with every edge dropped:

  dock          the edges as the dock selects them;
  all dropped   every edge j = i, so no edge is kept for the angles: the
                distance, its bin, the relpos class and the geometry alone.

Each line gives the time per call by CUDA events, the device time
(torch.profiler over 10 calls) and the enqueue time on the host
(time.perf_counter over 1,000 back-to-back calls with no synchronize),
then the host parts of one call (the argument checks, the output
allocations, the device guard and the stream lookup), each over 1,000
calls.  Printed first: the card's name and power limit, ptxas's resource
lines (`-Xptxas -v`) and the SASS instruction count (`cuobjdump -sass`,
NOPs left out; MUFU, the special-function instructions, beside it) of each
kernel of csrc/edge_table.cu, and how many edges and 32-edge chunks (a
warp's edges in one pass) the dock's inputs keep for the angles.

It uses only what chip_smoke.py and ops/edge_table.py have had since the
kernels were first ported, so a copy of it placed in another checkout's
scripts/ measures that checkout the same way.  --save writes the dock
inputs' ebin and egeo; --compare holds this checkout's against a saved
pair bit for bit.
"""
from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from dfmdock_tpu_torch.data.convert import load_npz_complex  # noqa: E402
from dfmdock_tpu_torch.features.sixd import sixd_values_at  # noqa: E402
from dfmdock_tpu_torch.ops import _build  # noqa: E402
from dfmdock_tpu_torch.ops import edge_table as et  # noqa: E402
from torch_energy_breakdown import ptxas_lines  # noqa: E402


def enqueue_ms(fn, calls=1000):
    """Host time per call over `calls` back-to-back calls, no synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = (time.perf_counter() - t0) / calls * 1e3
    torch.cuda.synchronize()
    return ms


def sass_counts(so: str) -> dict[str, tuple[int, int]]:
    """{kernel: (SASS instructions without NOPs, MUFU instructions)}."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", so], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : \w*?_cu_[0-9a-f]{8}(\d+)(\w+)", line)
        if m:  # the mangled name: its length, the name, then ILb1E for <true>
            size = int(m.group(1))
            name = m.group(2)[:size] + {"ILb1E": "<true>", "ILb0E": "<false>"}.get(
                m.group(2)[size:size + 5], "")
            counts[name] = [0, 0]
        elif name and (ins := re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                                        line)):
            op = ins.group(1)
            counts[name][0] += op != "NOP"
            counts[name][1] += op.startswith("MUFU")
    return {k: tuple(v) for k, v in counts.items()}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--save", help="write the dock inputs' ebin and egeo to this file")
    ap.add_argument("--compare", help="hold ebin and egeo against this saved file")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_edge_table_breakdown: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    cs.device_phase()
    for line in ptxas_lines("edge_table"):
        print(f"# ptxas {line}")
    _build.load("edge_table")
    for kernel, (n, mufu) in sass_counts(str(_build.library_path("edge_table"))).items():
        print(f"# sass {kernel}: {n} instructions, {mufu} MUFU")

    raw = load_npz_complex(cs.NPZ)
    batch, pos, idx, _ = cs.edge_inputs(raw, cs.N_PAD, cs.P, 0, dev)
    p, n, k = idx.shape
    rows = torch.arange(n, device=dev, dtype=idx.dtype)
    kept = (sixd_values_at(pos, idx)[0] < 22.0) & (idx != rows[:, None])
    chunks = [kept[..., k0:k0 + 32].any(-1) for k0 in range(0, k, 32)]
    print(f"# dock inputs P={p} N={n} K={k}: {int(kept.sum())}/{kept.numel()} edges kept "
          f"for the angles ({100 * float(kept.float().mean()):.2f}%); 32-edge chunks with "
          f"none kept: {sum(int((~c).sum()) for c in chunks)}/{sum(c.numel() for c in chunks)}")
    res_id, asym_id = batch["res_id"], batch["asym_id"]
    ebin, egeo = et.build_edge_table(idx, pos, res_id, asym_id, normalize=True)
    torch.cuda.synchronize()
    if opts.save:
        torch.save({"ebin": ebin.cpu(), "egeo": egeo.cpu()}, opts.save)
        print(f"# saved ebin and egeo to {opts.save}")
    if opts.compare:
        ref = torch.load(opts.compare)
        print(f"# against {opts.compare}: ebin entries that differ "
              f"{int((ebin.cpu() != ref['ebin']).sum())}/{ebin.numel()}, egeo "
              f"{int((egeo.cpu() != ref['egeo']).sum())}/{egeo.numel()}")

    dropped = rows.view(1, n, 1).expand(p, n, k).contiguous()
    for label, edges in (("dock", idx), ("all dropped", dropped)):
        args = (edges, pos, res_id, asym_id)
        for name, fn in (("edge_table", lambda: et.build_edge_table(*args, normalize=True)),
                         ("edge_bins", lambda: et.edge_bins(*args))):
            print(f"{name} {label}: events {cs.time_ms(fn):.4f} ms, device "
                  f"{cs.device_ms(fn):.4f} ms, host {enqueue_ms(fn):.4f} ms to enqueue",
                  flush=True)

    args = (idx, pos, res_id, asym_id)
    shapes = ((torch.int32, (p, n, k)), (torch.float32, (p, n, 3, 3)),
              (torch.int32, (n,)), (torch.int32, (n,)))
    e = p * n * k
    dev = pos.device  # cuda:0, as the wrappers see it

    def checks():
        for t, (dtype, shape) in zip(args, shapes):
            _build.require(t, "t", dtype, shape, dev)

    def one_buffer():
        buf = torch.empty(e * (et.EGEO_WIDTH + et.EBIN_WIDTH), dtype=torch.int32, device=dev)
        return (buf[e * et.EGEO_WIDTH:].view(p, n, k, et.EBIN_WIDTH),
                buf[:e * et.EGEO_WIDTH].view(torch.float32).view(p, n, k, et.EGEO_WIDTH))

    def device_guard():
        with torch.cuda.device(dev):
            pass

    parts = {
        "checks (4 x _build.require)": checks,
        "outputs: two torch.empty, shape as a tuple": lambda: (
            torch.empty((p, n, k, et.EBIN_WIDTH), dtype=torch.int32, device=dev),
            torch.empty((p, n, k, et.EGEO_WIDTH), dtype=torch.float32, device=dev)),
        "outputs: two torch.empty, shape as arguments": lambda: (
            torch.empty(p, n, k, et.EBIN_WIDTH, dtype=torch.int32, device=dev),
            torch.empty(p, n, k, et.EGEO_WIDTH, dtype=torch.float32, device=dev)),
        "outputs: one torch.empty split into two views": one_buffer,
        "torch.cuda.device context": device_guard,
        "torch.cuda.current_device() == index": lambda: torch.cuda.current_device() == dev.index,
        "torch.cuda.current_stream(dev).cuda_stream": lambda: torch.cuda.current_stream(
            dev).cuda_stream,
        "torch._C._cuda_getCurrentRawStream(index)": lambda: torch._C._cuda_getCurrentRawStream(
            dev.index),
        "6 x data_ptr()": lambda: [t.data_ptr() for t in args + args[:2]],
    }
    for label, fn in parts.items():
        print(f"# host part {label}: {enqueue_ms(fn):.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
