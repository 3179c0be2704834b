"""The JAX package's own random draws of the DFMDock witness sweeps, saved for the port.

    python3 scripts/export_jax_draws.py [--seeds 5,6,...,30] [--out FILE]

For each seed and each complex of the JAX record eval_train.csv (in the
record's order, ckpts/db5_holdout_dfmdock), the key the record's sweep gave
the complex (PRNGKey(seed) split once per complex, as
scripts/dfmdock_witness.py's `jax-bf16` side) is split into the sweep's 40
pose keys, and each pose key into the draws `dfmdock_tpu/sampler/em.py`
makes from it (EMSampler.sample_one): the start pose's Gaussian quaternion
[4] and translation normals [1, 3] (`randomize_pose`), and each step's
rotation and translation normals [1, 3] (`SO3Diffuser.reverse_step`,
`R3Diffuser.reverse_step`, before the noise scale).  The edges' Gumbel
noise (40 steps of [40, N, N]) is not saved.

Writes one npz (default ckpts/db5_holdout_dfmdock/jax_draws.npz, ~3.9 MB
for the default seeds 5-30):
for each seed s and complex c, `s{s}/{c}/quat` [P, 4], `s{s}/{c}/tr` [P, 1,
3], `s{s}/{c}/z_rot` and `s{s}/{c}/z_tr` [steps, P, 1, 3], float32, the
layout of the port's `EMSampler.sample(noise=)`.  scripts/dfmdock_witness.py
--sides port-cuda-bf16-jax-draws injects them (`sampler/em.place_pose`).
Imports JAX and runs on the CPU (a few seconds); it is not part of the port.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "ckpts", "db5_holdout_dfmdock", "jax_draws.npz")
RECORD_ORDER = ("1AVX", "1ZHI", "2SNI", "4POU")  # the record sweep's ids, in order
NUM_SAMPLES = NUM_STEPS = 40
SEEDS = range(5, 31)  # the witness seeds the committed file holds


def pose_draws(key, num_steps):
    """The draws EMSampler.sample_one makes from one pose key."""
    import jax

    k_init, k_loop = jax.random.split(key)
    k_rot, k_tr = jax.random.split(k_init)

    def step(k):
        _, k_r, k_t = jax.random.split(k, 3)
        return jax.random.normal(k_r, (1, 3)), jax.random.normal(k_t, (1, 3))

    z_rot, z_tr = jax.vmap(step)(jax.random.split(k_loop, num_steps))
    return {"quat": jax.random.normal(k_rot, (4,)), "tr": jax.random.normal(k_tr, (1, 3)),
            "z_rot": z_rot, "z_tr": z_tr}


def sample_draws(key, num_samples, num_steps):
    """The draws of EMSampler.sample(key, num_samples) in the port's layout:
    quat [P, 4], tr [P, 1, 3], z_rot / z_tr [steps, P, 1, 3] (numpy)."""
    import jax

    d = jax.vmap(lambda k: pose_draws(k, num_steps))(jax.random.split(key, num_samples))
    out = {k: np.asarray(v, np.float32) for k, v in d.items()}
    for k in ("z_rot", "z_tr"):
        out[k] = np.ascontiguousarray(out[k].transpose(1, 0, 2, 3))
    return out


def record_draws(seeds, num_samples=NUM_SAMPLES, num_steps=NUM_STEPS):
    """{f"s{seed}/{complex}/{name}": array} over the record's complexes."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    out = {}
    for seed in seeds:
        key = jax.random.PRNGKey(seed)
        for cid in RECORD_ORDER:
            key, sub = jax.random.split(key)
            for name, v in sample_draws(sub, num_samples, num_steps).items():
                out[f"s{seed}/{cid}/{name}"] = v
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seeds", default=",".join(map(str, SEEDS)))
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    draws = record_draws([int(s) for s in args.seeds.split(",")])
    np.savez_compressed(args.out, **draws)
    print(f"wrote {args.out}: {len(draws)} arrays, {os.path.getsize(args.out) / 1e6:.2f} MB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
