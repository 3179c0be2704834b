"""Export a trained orbax checkpoint of the JAX package to a flat-dict .npz.

    python scripts/export_torch_weights.py ckpts/db5_demo
    python scripts/export_torch_weights.py ckpts/db5_holdout_dfmdock --lineage dfmdock

Restores `<dir>/last` with the JAX package's own loader
(`dfmdock_tpu.cli.common.load_model`, the model built from `<dir>/config.yaml`)
and writes `<dir>/weights.npz`: every parameter as float32 under its
"/"-joined pytree path ("egnn/3/edge_mlp/l0/w"), compressed.  That file is
what `dfmdock_tpu_torch.params.load_npz` and the port's `--ckpt` read, so the
port needs no JAX to run the trained weights.  This script is not part of the
port and imports JAX; it runs on the CPU.
"""
from __future__ import annotations

import argparse
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from dfmdock_tpu.cli.common import load_model  # noqa: E402
from dfmdock_tpu.config import from_yaml  # noqa: E402


def flat_params(params) -> dict:
    """JAX pytree -> {"a/b/0/w": float32 numpy array}."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        out[key] = np.asarray(leaf, np.float32)
    return out


def export(ckpt_dir: str, lineage: str, out: str | None = None) -> str:
    cfg = from_yaml(os.path.join(ckpt_dir, "config.yaml"))
    _, params = load_model(os.path.join(ckpt_dir, "last"), cfg, lineage=lineage)
    flat = flat_params(params)
    out = out or os.path.join(ckpt_dir, "weights.npz")
    np.savez_compressed(out, **flat)
    n = sum(v.size for v in flat.values())
    print(f"{out}: {len(flat)} arrays, {n:,} parameters, "
          f"{os.path.getsize(out) / 2**20:.2f} MiB")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("ckpt_dir", help="a checkpoint directory holding config.yaml and last/")
    ap.add_argument("--lineage", choices=["mlsb", "dfmdock"], default="mlsb")
    ap.add_argument("--out", default=None, help="default: <ckpt_dir>/weights.npz")
    args = ap.parse_args(argv)
    export(args.ckpt_dir, args.lineage, args.out)


if __name__ == "__main__":
    main()
