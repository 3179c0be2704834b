"""Training runs of a checkpoint's protocol on one card, and their sweeps:
db5_holdout_dfmdock's (ROADMAP F7: how far the port's own training runs
scatter; the default) or db5_demo's (ckpts/db5_demo_torch/README.md).

    python3 scripts/f7_runs.py --runs 1 --out-dir chiprun_out/f7 \\
        [--weights-dir tmp/f7] [--keep-weights chiprun_out/f7/weights]
    python3 scripts/f7_runs.py --protocol db5_demo --half 1 --out-dir chiprun_out/demo \\
        --weights-dir chiprun_out/demo/weights
    python3 scripts/f7_runs.py --protocol db5_demo --sweep-only --out-dir chiprun_out/demo
    python3 scripts/f7_runs.py --protocol db5_demo --summarize ckpts/db5_demo_torch/sweeps

`dfmdock_holdout`: the protocol of ckpts/db5_holdout_dfmdock_torch/README.md
through the training CLI: `--lineage dfmdock --grad-energy --crop-size 448
--exclude-ids 1QA9,7CEI,2SIC,1JPS`, two halves of 400 epochs, the
second `--resume`d from the first's weights with `--save-offset`, so with a
fresh optimizer, as the JAX package's resume.  A run `N` trains at `--seed
N`; `N:bfloat16` at `--compute-dtype bfloat16`.  Its tag is `seedN`
(`seedN-bf16`).  Each half's `metrics.jsonl` goes to OUT_DIR/TAG/, the
weights to WEIGHTS_DIR/TAG/ (keep that out of what comes back: one
weights.npz is 14 MiB).

`db5_demo`: the command of ckpts/db5_demo/README.md (`--crop-size 448
--grad-energy --use-contrastive-loss --seed 41`, all 24 complexes, float32)
as two halves of 1000 epochs with `--save-every 500`, the second resumed
from HALFWAY (half 1's epoch999 weights, copied there between the calls)
with `--save-offset 1000`.  `--half N` trains one half (a half is ~50 min
of the card, so one a chip call).

The runs train one after another, each alone on the card: two runs made at
once in one process (a thread and a stream each) do not compute what each
computes alone (scripts/f7_concurrent_check.py).

Then, for `dfmdock_holdout`, each run's final weights are swept over seeds
5-14 on the four
training complexes of eval_train.csv and on the four held-out ones through
`scripts/dfmdock_witness.py --sides port-cuda` (the float32 kernel route,
40 poses, 40-step EM), into OUT_DIR/witness_train and
OUT_DIR/witness_holdout as SIDE@TAG, every sweep in a process of its own,
all at once.  The sweeps' kernels are built while the runs train.
`--keep-weights DIR` copies each run's final weights to DIR/TAG/ before
the sweeps.  For `db5_demo` (`--sweep-only`), the port-trained and the
JAX-trained weights each go through the sweep CLI on its default route
(bf16), all 24 complexes x 16 poses, over seeds 5-14, one process a weight
set, into OUT_DIR/sweeps/TAG_seedN.csv; the summary prints each seed's
numbers, the paired difference and the verdict of the reproduction rule
(ckpts/db5_demo_torch/README.md).  Prints one JSON line per half (steps, training-loop seconds,
captures, replays) and the summaries.  Needs a CUDA card, but for
`--summarize`.
"""
from __future__ import annotations

import argparse
import csv
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))


@dataclasses.dataclass(frozen=True)
class Protocol:
    flags: tuple        # the training CLI's arguments common to both halves
    epochs: int         # a half
    log_every: int
    save_every: int = 0
    runs: str | None = None     # the runs' spec, when the protocol fixes it
    halfway: str | None = None  # half 2 resumes from here (else half 1's ckpt dir)


PROTOCOLS = {
    "dfmdock_holdout": Protocol(
        flags=("--lineage", "dfmdock", "--grad-energy", "--crop-size", "448",
               "--exclude-ids", "1QA9,7CEI,2SIC,1JPS"),
        epochs=400, log_every=400),
    "db5_demo": Protocol(
        flags=("--crop-size", "448", "--grad-energy", "--use-contrastive-loss"),
        epochs=1000, log_every=400, save_every=500, runs="41",
        halfway=os.path.join("ckpts", "db5_demo_torch", "epoch999", "weights.npz")),
}
TRAIN_IDS = "1AVX,1ZHI,2SNI,4POU"
HOLDOUT_IDS = "1QA9,7CEI,2SIC,1JPS"
SWEEP_SEEDS = ",".join(str(s) for s in range(5, 15))
# built while the runs train (select_topk, which training launches, builds
# at its first launch)
SWEEP_KERNELS = ("edge_table", "energy_head", "fused_egcl")
# db5_demo's sweeps: the weight sets (tag: weights), 16 poses a complex as
# eval_all.csv, and the record whose bootstrap margins the rule uses
DEMO_SETS = {"torch": os.path.join("ckpts", "db5_demo_torch", "weights.npz"),
             "jax": os.path.join("ckpts", "db5_demo", "weights.npz")}
DEMO_POSES = 16
DEMO_RECORD = os.path.join("ckpts", "db5_demo", "eval_all.csv")


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


def half_argv(seed, dtype, epochs, half, out_dir, weights_dir, device,
              protocol="dfmdock_holdout"):
    """The training CLI's arguments for one half of a run."""
    proto = PROTOCOLS[protocol]
    tag = run_tag(seed, dtype)
    ck = os.path.join(weights_dir, tag, f"half{half}")
    argv = list(proto.flags) + [
        "--epochs", str(epochs), "--seed", str(seed), "--log-every", str(proto.log_every),
        "--compute-dtype", dtype, "--device", device, "--ckpt-dir", ck,
        "--metrics-json", os.path.join(out_dir, tag, f"metrics_half{half}.jsonl")]
    if proto.save_every:
        argv += ["--save-every", str(proto.save_every)]
    if half == 2:
        argv += ["--resume", proto.halfway or os.path.join(weights_dir, tag, "half1",
                                                           "weights.npz"),
                 "--save-offset", str(epochs)]
    return argv


def train_run(seed, dtype, args, report):
    """The halves of one run through the training CLI (both, or `--half`);
    a JSON line per half, printed and appended to `report`."""
    from dfmdock_tpu_torch.cli import train

    tag = run_tag(seed, dtype)
    os.makedirs(os.path.join(args.out_dir, tag), exist_ok=True)
    for half in args.halves:
        out = train.main(half_argv(seed, dtype, args.epochs, half, args.out_dir,
                                   args.weights_dir, args.device, args.protocol))
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
    return [(run_tag(s, d), os.path.join(args.weights_dir, run_tag(s, d), "half2",
                                         "weights.npz"))
            for s, d in runs]


def wait_all(jobs):
    """Wait for every (label, process, log) job, failed or not; raise if
    any failed."""
    t0, failed = time.perf_counter(), []
    for label, proc, log in jobs:
        rc = proc.wait()
        log.close()
        print(f"# sweep {label}: rc {rc}, done at {time.perf_counter() - t0:.1f} s", flush=True)
        if rc:
            failed.append(label)
    if failed:
        raise RuntimeError(f"sweeps failed: {', '.join(failed)}")


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
    try:
        wait_all(jobs)
    finally:
        for out in dirs.values():
            dfmdock_witness.main(["--summarize", out])


def demo_sweeps(weights, out_dir, tag):
    """One weight set through the sweep CLI on its default route, all 24
    complexes x DEMO_POSES poses, at each sweep seed: OUT_DIR/TAG_seedN.csv."""
    from dfmdock_tpu_torch.cli import sweep

    for seed in SWEEP_SEEDS.split(","):
        t0 = time.perf_counter()
        sweep.main(["--ckpt", weights, "--num-samples", str(DEMO_POSES), "--seed", seed,
                    "--out-csv", os.path.join(out_dir, f"{tag}_seed{seed}.csv")])
        print(f"# {tag} seed {seed}: {time.perf_counter() - t0:.1f} s", flush=True)


def demo_sweep_all(args):
    """Both weight sets over the sweep seeds, one process a set, both at
    once, each logging to OUT_DIR/sweep_TAG.log; then the summary."""
    from dfmdock_tpu_torch.ops import _build

    _build.build(*SWEEP_KERNELS, "select_topk")  # once, before the processes start
    out = os.path.join(args.out_dir, "sweeps")
    os.makedirs(out, exist_ok=True)
    jobs = []
    for tag, path in DEMO_SETS.items():
        log = open(os.path.join(args.out_dir, f"sweep_{tag}.log"), "w")
        code = (f"import sys; sys.path.insert(0, {os.path.join(ROOT, 'scripts')!r}); "
                f"import f7_runs; f7_runs.demo_sweeps({path!r}, {out!r}, tag={tag!r})")
        jobs.append((tag, subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, stdout=log,
                                           stderr=subprocess.STDOUT), log))
    try:
        wait_all(jobs)
    finally:
        demo_summary(out)


def seed_stats(path):
    """(mean DockQ over all poses, min-energy pick mean, acceptable+ picks)
    of one sweep CSV."""
    import chip_smoke

    with open(path) as f:
        s = chip_smoke.dockq_stats(chip_smoke.by_complex(csv.DictReader(f)))
    return s["mean_all"], s["pick_mean"], s["acceptable"]


def demo_summary(sweep_dir, record=DEMO_RECORD) -> dict:
    """Each seed's numbers for both weight sets (TAG_seedN.csv in
    `sweep_dir`), the paired difference jax - torch over the seeds both
    have (mean, se) and the rule's verdict: reproduced if the port-trained
    seed-means of mean DockQ and pick mean each lie no lower than the
    JAX-trained ones by more than the record's bootstrap margins."""
    import chip_smoke

    stats = {}
    for name in sorted(os.listdir(sweep_dir)):
        tag, sep, rest = name.partition("_seed")
        if sep and tag in DEMO_SETS and rest.endswith(".csv"):
            stats.setdefault(tag, {})[int(rest[:-4])] = seed_stats(os.path.join(sweep_dir, name))
    seeds = sorted(set(stats.get("torch", {})) & set(stats.get("jax", {})))
    if not seeds:
        print(f"# {sweep_dir}: no seed swept with both weight sets")
        return {}
    for seed in seeds:
        t, j = stats["torch"][seed], stats["jax"][seed]
        print(f"# seed {seed}: port-trained mean DockQ {t[0]:.4f} pick mean {t[1]:.4f} "
              f"acceptable+ {t[2]}/24; JAX-trained {j[0]:.4f} / {j[1]:.4f} / {j[2]}/24")
    with open(record) as f:
        margin = chip_smoke.bootstrap_margins(chip_smoke.by_complex(csv.DictReader(f)))
    t = np.array([stats["torch"][s] for s in seeds], dtype=np.float64)
    j = np.array([stats["jax"][s] for s in seeds], dtype=np.float64)
    d = j - t
    se = d.std(0, ddof=1) / np.sqrt(len(seeds)) if len(seeds) > 1 else np.full(3, np.nan)
    out = {"seeds": seeds, "torch": t.mean(0).tolist(), "jax": j.mean(0).tolist(),
           "diff": d.mean(0).tolist(), "se": se.tolist(),
           "margin": [margin["mean_all"], margin["pick_mean"]]}
    out["reproduced"] = bool(t.mean(0)[0] >= j.mean(0)[0] - margin["mean_all"]
                             and t.mean(0)[1] >= j.mean(0)[1] - margin["pick_mean"])
    for k, name in enumerate(("mean DockQ", "pick mean", "acceptable+")):
        print(f"# over {len(seeds)} seeds, {name}: port-trained {t[:, k].mean():.4f}, "
              f"JAX-trained {j[:, k].mean():.4f}; JAX-trained minus port-trained "
              f"{d[:, k].mean():+.4f} (se {se[k]:.4f})"
              + (f"; margin {out['margin'][k]:.4f}" if k < 2 else ""))
    print("# verdict: " + ("reproduced" if out["reproduced"] else
                           "not reproduced: F8 opens (ROADMAP Queue 3)"))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--protocol", choices=sorted(PROTOCOLS), default="dfmdock_holdout")
    ap.add_argument("--runs", default=None,
                    help="comma-separated training seeds, each optionally :bfloat16 "
                         "(db5_demo: its own, 41)")
    ap.add_argument("--half", type=int, choices=(1, 2), default=None,
                    help="train this half alone, and no sweeps")
    ap.add_argument("--sweep-only", action="store_true",
                    help="db5_demo: sweep both weight sets, no training")
    ap.add_argument("--summarize", default=None, metavar="DIR",
                    help="db5_demo: the summary of the sweep CSVs in DIR")
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--weights-dir", default=os.path.join(ROOT, "tmp", "f7_weights"))
    ap.add_argument("--keep-weights", default=None, metavar="DIR",
                    help="copy each run's final weights to DIR/TAG/weights.npz")
    args = ap.parse_args(argv)
    proto = PROTOCOLS[args.protocol]
    demo = args.protocol == "db5_demo"
    if (args.sweep_only or args.summarize) and not demo:
        ap.error("--sweep-only and --summarize are db5_demo's")
    if args.summarize:
        demo_summary(args.summarize)
        return 0
    if args.out_dir is None:
        ap.error("--out-dir is required")
    if args.sweep_only:
        demo_sweep_all(args)
        return 0
    spec = proto.runs or args.runs
    if spec is None:
        ap.error("--runs is required")
    if demo and args.half is None:
        ap.error("db5_demo trains one half a call: give --half")
    args.epochs, args.device = proto.epochs, "cuda"
    args.halves = (args.half,) if args.half else (1, 2)
    runs = parse_runs(spec)
    # the sweeps' kernels compile (nvcc, on the host) while the runs train
    from dfmdock_tpu_torch.ops import _build

    build = None if args.half else threading.Thread(target=_build.build, args=SWEEP_KERNELS)
    if build:
        build.start()
    t0 = time.perf_counter()
    try:
        report = train_all(runs, args)
    finally:
        if build:
            build.join()
    wall = time.perf_counter() - t0
    steps = sum(r["steps"] for r in report)
    print(json.dumps({"runs": [run_tag(s, d) for s, d in runs], "steps": steps, "wall_s": round(wall, 3),
                      "steps_s": round(steps / wall, 3)}), flush=True)
    if args.half:
        return 0
    if args.keep_weights:
        for tag, path in final_weights(runs, args):
            os.makedirs(os.path.join(args.keep_weights, tag), exist_ok=True)
            shutil.copy(path, os.path.join(args.keep_weights, tag, "weights.npz"))
    sweep_all(runs, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
