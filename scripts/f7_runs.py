"""Training runs of db5_holdout_dfmdock's protocol on one card, and their sweeps
(ROADMAP F7: how far the port's own training runs scatter).

    python3 scripts/f7_runs.py --runs 1 --out-dir chiprun_out/f7 \\
        [--weights-dir tmp/f7] [--keep-weights chiprun_out/f7/weights]

Each run is the protocol of ckpts/db5_holdout_dfmdock_torch/README.md through
the training CLI: `--lineage dfmdock --grad-energy --crop-size 448
--exclude-ids 1QA9,7CEI,2SIC,1JPS`, two halves of 400 epochs, the
second `--resume`d from the first's weights with `--save-offset`, so with a
fresh optimizer, as the JAX package's resume.  A run `N` trains at `--seed
N`; `N:bfloat16` at `--compute-dtype bfloat16`.  Its tag is `seedN`
(`seedN-bf16`).  Each half's `metrics.jsonl` goes to OUT_DIR/TAG/, the
weights to WEIGHTS_DIR/TAG/ (keep that out of what comes back: one
weights.npz is 14 MiB).

The runs train one after another, each alone on the card: two runs made at
once in one process (a thread and a stream each) do not compute what each
computes alone (scripts/f7_concurrent_check.py).

Then each run's final weights are swept over seeds 5-14 on the four
training complexes of eval_train.csv and on the four held-out ones through
`scripts/dfmdock_witness.py --sides port-cuda` (the float32 kernel route,
40 poses, 40-step EM), into OUT_DIR/witness_train and
OUT_DIR/witness_holdout as SIDE@TAG, every sweep in a process of its own,
all at once.  The sweeps' kernels are built while the runs train.
`--keep-weights DIR` copies each run's final weights to DIR/TAG/ before
the sweeps.  Prints one JSON line per half (steps, training-loop seconds,
captures, replays) and the summaries of both directories
(`dfmdock_witness.py --summarize`).  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

PROTOCOL = ["--lineage", "dfmdock", "--grad-energy", "--crop-size", "448",
            "--exclude-ids", "1QA9,7CEI,2SIC,1JPS"]
TRAIN_IDS = "1AVX,1ZHI,2SNI,4POU"
HOLDOUT_IDS = "1QA9,7CEI,2SIC,1JPS"
EPOCHS = 400  # a half
SWEEP_SEEDS = ",".join(str(s) for s in range(5, 15))
# built while the runs train (select_topk, which training launches, builds
# at its first launch)
SWEEP_KERNELS = ("edge_table", "energy_head", "fused_egcl")


def parse_runs(spec: str) -> list[tuple[int, str]]:
    """`1,2,1:bfloat16` -> [(1, "float32"), (2, "float32"), (1, "bfloat16")]."""
    runs = []
    for item in (s for s in spec.split(",") if s):
        seed, _, dtype = item.partition(":")
        if dtype not in ("", "float32", "bfloat16"):
            raise ValueError(f"run {item!r}: the dtype is float32 or bfloat16")
        runs.append((int(seed), dtype or "float32"))
    return runs


def run_tag(seed: int, dtype: str) -> str:
    return f"seed{seed}" + ("-bf16" if dtype == "bfloat16" else "")


def half_argv(seed, dtype, epochs, half, out_dir, weights_dir, device):
    """The training CLI's arguments for one half of a run."""
    tag = run_tag(seed, dtype)
    ck = os.path.join(weights_dir, tag, f"half{half}")
    argv = PROTOCOL + ["--epochs", str(epochs), "--seed", str(seed), "--log-every",
                       str(epochs), "--compute-dtype", dtype, "--device", device,
                       "--ckpt-dir", ck,
                       "--metrics-json", os.path.join(out_dir, tag, f"metrics_half{half}.jsonl")]
    if half == 2:
        argv += ["--resume", os.path.join(weights_dir, tag, "half1", "weights.npz"),
                 "--save-offset", str(epochs)]
    return argv


def train_run(seed, dtype, args, report):
    """Both halves of one run through the training CLI; a JSON line per
    half, printed and appended to `report`."""
    from dfmdock_tpu_torch.cli import train

    tag = run_tag(seed, dtype)
    os.makedirs(os.path.join(args.out_dir, tag), exist_ok=True)
    for half in range(1, args.halves + 1):
        out = train.main(half_argv(seed, dtype, args.epochs, half, args.out_dir,
                                   args.weights_dir, args.device))
        line = {"run": tag, "half": half, "steps": out["steps"],
                "wall_s": round(out["wall"], 3),
                "steps_s": round(out["steps"] / out["wall"], 3),
                "captures": out["graph"]["captures"], "replays": out["graph"]["replays"]}
        print(json.dumps(line), flush=True)
        report.append(line)


def train_all(runs, args) -> list[dict]:
    """Every run, one after another.  Returns the halves' lines."""
    report = []
    for seed, dtype in runs:
        train_run(seed, dtype, args, report)
    return report


def final_weights(runs, args) -> list[tuple[str, str]]:
    """(tag, weights.npz) of each run's last half."""
    return [(run_tag(s, d), os.path.join(args.weights_dir, run_tag(s, d),
                                         f"half{args.halves}", "weights.npz"))
            for s, d in runs]


def sweep_all(runs, args):
    """Each run's final weights over the sweep seeds, on the training and
    the held-out complexes: one
    process a sweep, all at once (a sweep keeps the card mostly idle, its
    time going to host dispatch), each logging to OUT_DIR/sweep_TAG_SET.log;
    then the summary of both directories."""
    import dfmdock_witness

    weights = final_weights(runs, args)
    dirs = {("train", TRAIN_IDS): os.path.join(args.out_dir, "witness_train"),
            ("holdout", HOLDOUT_IDS): os.path.join(args.out_dir, "witness_holdout")}
    jobs = []
    for tag, path in weights:
        for (name, ids), out in dirs.items():
            log = open(os.path.join(args.out_dir, f"sweep_{tag}_{name}.log"), "w")
            cmd = [sys.executable, os.path.join(ROOT, "scripts", "dfmdock_witness.py"),
                   "--sides", "port-cuda", "--ckpt", path, "--tag", tag, "--ids", ids,
                   "--seeds", SWEEP_SEEDS, "--out-dir", out]
            jobs.append((f"{tag} {name}", subprocess.Popen(cmd, stdout=log,
                                                           stderr=subprocess.STDOUT), log))
    t0, failed = time.perf_counter(), []
    for label, proc, log in jobs:   # every process is waited for, failed or not
        rc = proc.wait()
        log.close()
        print(f"# sweep {label}: rc {rc}, done at {time.perf_counter() - t0:.1f} s", flush=True)
        if rc:
            failed.append(label)
    for out in dirs.values():
        dfmdock_witness.main(["--summarize", out])
    if failed:
        raise RuntimeError(f"sweeps failed: {', '.join(failed)}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--runs", required=True,
                    help="comma-separated training seeds, each optionally :bfloat16")
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--weights-dir", default=os.path.join(ROOT, "tmp", "f7_weights"))
    ap.add_argument("--keep-weights", default=None, metavar="DIR",
                    help="copy each run's final weights to DIR/TAG/weights.npz")
    args = ap.parse_args(argv)
    args.epochs, args.halves, args.device = EPOCHS, 2, "cuda"
    runs = parse_runs(args.runs)
    # the sweeps' kernels compile (nvcc, on the host) while the runs train
    from dfmdock_tpu_torch.ops import _build

    build = threading.Thread(target=_build.build, args=SWEEP_KERNELS)
    build.start()
    t0 = time.perf_counter()
    try:
        report = train_all(runs, args)
    finally:
        build.join()
    wall = time.perf_counter() - t0
    steps = sum(r["steps"] for r in report)
    print(json.dumps({"runs": [run_tag(s, d) for s, d in runs], "steps": steps, "wall_s": round(wall, 3),
                      "steps_s": round(steps / wall, 3)}), flush=True)
    if args.keep_weights:
        for tag, path in final_weights(runs, args):
            os.makedirs(os.path.join(args.keep_weights, tag), exist_ok=True)
            shutil.copy(path, os.path.join(args.keep_weights, tag, "weights.npz"))
    sweep_all(runs, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
