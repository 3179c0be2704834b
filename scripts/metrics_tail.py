"""The end of a training run's loss curve: the mean of each loss term over
the last N logged lines of one or more `metrics.jsonl` files (the training
CLI's `--metrics-json`, the JAX package's and the port's alike), and the
lines' steps.

    python3 scripts/metrics_tail.py ckpts/db5_holdout_dfmdock/metrics.jsonl \\
        ckpts/db5_holdout_dfmdock_torch/metrics.jsonl --last 20
"""
from __future__ import annotations

import argparse
import json
import sys

TERMS = ("loss", "tr_loss", "rot_loss", "ec_loss", "ires_loss")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("files", nargs="+")
    ap.add_argument("--last", type=int, default=20, help="logged lines to average")
    args = ap.parse_args(argv)
    for path in args.files:
        with open(path) as f:
            rows = [json.loads(line) for line in f if line.strip()]
        tail = rows[-args.last:]
        means = " ".join(f"{k} {sum(r[k] for r in tail) / len(tail):.4f}" for k in TERMS)
        print(f"# {path}: {len(rows)} lines; the last {len(tail)} (epochs {tail[0]['epoch']}-"
              f"{tail[-1]['epoch']} of their run): {means}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
