"""Whether two training runs made at once in one process compute what each
computes alone, bit for bit (they do not: ROADMAP F7).

    CUBLAS_WORKSPACE_CONFIG=:4096:8 python3 scripts/f7_concurrent_check.py \\
        [--out-dir chiprun_out/f7_check]

Two runs at once: each run of the training CLI in a thread of its own, on a
CUDA stream of its own, so that one run's small kernels might fill the SMs
that the other's leave idle.  Each half's first step is captured as a CUDA
graph (train/pool.PoolStep); here the captures take one lock and run in the
`thread_local` capture mode, so that the other thread's replays and host
copies go on meanwhile, and the second run starts once the first has
captured its graph.  Each run draws from its own generators.

Under torch.use_deterministic_algorithms a run of the training CLI repeats
itself bit for bit (ROADMAP F6), so a difference between a run made alone
and the same run made beside another is the concurrency's.  Seed 1 trains
alone, then seeds 1 and 2 at once, each at the F7 protocol
(scripts/f7_runs.py) cut to EPOCHS with a pool refresh every POOL_REFRESH
epochs (one half, no sweep); then every weight array of seed
1's two runs is compared.  Where they differ, seed 1 trains alone once more,
to tell the concurrency from a run that does not repeat itself.  Prints one
line per comparison and exits non-zero if the concurrent run differs.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import os
import sys
import threading

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import f7_runs  # noqa: E402

# each run: 30 epochs of the 40-row pool (1,200 steps), a pool refresh
# every 10, long enough for the two runs to overlap by most of their steps
EPOCHS, POOL_REFRESH = 30, 10


@contextlib.contextmanager
def concurrent_captures(first_capture: dict):
    """Graph captures that another thread's work may run beside: the capture
    mode `thread_local` and one capture at a time.  `first_capture` maps a
    thread to the Event set after its first capture."""
    from dfmdock_tpu_torch.train import pool

    lock = threading.Lock()
    capture = pool.PoolStep._capture
    graph = torch.cuda.graph

    def locked_capture(self):
        with lock:
            capture(self)
        event = first_capture.get(threading.get_ident())
        if event is not None:
            event.set()

    pool.PoolStep._capture = locked_capture
    torch.cuda.graph = functools.partial(graph, capture_error_mode="thread_local")
    try:
        yield
    finally:
        pool.PoolStep._capture = capture
        torch.cuda.graph = graph


def train_at_once(runs, args) -> list[dict]:
    """f7_runs.train_run of every run at once, each in its own thread and
    stream, each started once the one before has captured its graph.
    Returns the halves' lines."""
    report, first_capture, errors, threads = [], {}, [], []

    def body(seed, dtype, started):
        first_capture[threading.get_ident()] = started
        try:
            with torch.cuda.stream(torch.cuda.Stream()):
                f7_runs.train_run(seed, dtype, args, report)
                torch.cuda.current_stream().synchronize()
        except BaseException as exc:   # re-raised by the main thread
            errors.append((f7_runs.run_tag(seed, dtype), exc))
            raise
        finally:
            started.set()

    with concurrent_captures(first_capture):
        for seed, dtype in runs:
            started = threading.Event()
            t = threading.Thread(target=body, args=(seed, dtype, started))
            t.start()
            threads.append(t)
            started.wait()
        for t in threads:
            t.join()
    if errors:
        raise RuntimeError(f"run {errors[0][0]} failed") from errors[0][1]
    return report


def weights(weights_dir, tag="seed1"):
    return dict(np.load(os.path.join(weights_dir, tag, "half1", "weights.npz")))


def compare(label, a, b) -> bool:
    """Print how far two weight sets lie apart; True if bit-equal."""
    diff = {k: float(np.abs(a[k].astype(np.float64) - b[k]).max()) for k in a}
    differing = [k for k, v in diff.items() if v > 0]
    print(f"# {label}: {len(differing)} of {len(diff)} arrays differ, max abs "
          f"{max(diff.values()):.3e}", flush=True)
    return not differing


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out-dir", default=os.path.join(ROOT, "chiprun_out", "f7_check"))
    ap.add_argument("--weights-dir", default=os.path.join(ROOT, "tmp", "f7_check"))
    args = ap.parse_args(argv)
    torch.use_deterministic_algorithms(True, warn_only=True)
    f7_runs.PROTOCOL = f7_runs.PROTOCOL + ["--pool-refresh", str(POOL_REFRESH)]

    def train(runs, at_once, name):
        run_args = argparse.Namespace(epochs=EPOCHS, halves=1,
                                      out_dir=os.path.join(args.out_dir, name),
                                      weights_dir=os.path.join(args.weights_dir, name),
                                      device="cuda")
        lines = (train_at_once if at_once else f7_runs.train_all)(runs, run_args)
        for line in lines:
            print(f"# {name}: {line}", flush=True)
        return run_args.weights_dir

    alone = train([(1, "float32")], False, "alone")
    together = train([(1, "float32"), (2, "float32")], True, "together")
    if compare("seed 1 alone against seed 1 beside seed 2", weights(alone),
               weights(together)):
        return 0
    again = train([(1, "float32")], False, "alone_again")
    compare("seed 1 alone against seed 1 alone again", weights(alone), weights(again))
    return 1


if __name__ == "__main__":
    sys.exit(main())
