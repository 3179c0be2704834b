"""Device-resident training pool (mirrors `dfmdock_tpu/train/pool.py`).

The training set is featurized once on the host (crops, chain swaps and
augmentation rotations from a `np.random.RandomState`, so a seed gives the
JAX package's pool exactly), stacked into one [B, ...] pool and uploaded
once.  An epoch is a plain loop over a permutation of the pool's rows, each
visit rotated on the device by a uniform SO(3) rotation drawn from the
run's `torch.Generator`; the per-step metrics stay on the device until the
epoch ends.  `batch_size` B averages the gradients of B rows per optimizer
step (the JAX package's vmap), one forward and backward after another.

Crop and chain-swap variants are baked per pool build; the training CLI
rebuilds the pool every few epochs to resample them (`--pool-refresh`).
"""
from __future__ import annotations

import numpy as np
import torch

from dfmdock_tpu_torch.data.batching import pad_complex
from dfmdock_tpu_torch.data.crop import crop_complex
from dfmdock_tpu_torch.features.residues import sequence_to_onehot
from dfmdock_tpu_torch.geom import random_rotation_matrix
from dfmdock_tpu_torch.parallel.world import all_reduce_mean, all_reduce_mean_grads

MODEL_KEYS = ("x", "pos", "node_mask", "lig_mask", "res_id", "asym_id")


def np_random_rotation(rng: np.random.RandomState) -> np.ndarray:
    """Uniform SO(3) rotation matrix from a host numpy RNG (unit quaternion)."""
    q = rng.randn(4)
    q = q / np.linalg.norm(q)
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ],
        dtype=np.float32,
    )


def make_training_batch(raw, crop_size, pad_to, rng, use_esm=True, shuffle_chains=True):
    """Featurize and augment one complex: optional receptor/ligand swap,
    crop, random global rotation about the CA centroid
    (ppi_mlsb_dataset.py:380-403 semantics); a padded numpy batch."""
    rec_x = np.concatenate([raw["rec_x"], sequence_to_onehot(raw["rec_seq"])], -1)
    lig_x = np.concatenate([raw["lig_x"], sequence_to_onehot(raw["lig_seq"])], -1)
    rec_pos, lig_pos = raw["rec_pos"], raw["lig_pos"]
    if not use_esm:
        rec_x = sequence_to_onehot(raw["rec_seq"])
        lig_x = sequence_to_onehot(raw["lig_seq"])

    if shuffle_chains and rng.rand() < 0.5:
        rec_x, lig_x = lig_x, rec_x
        rec_pos, lig_pos = lig_pos, rec_pos

    rec_x, lig_x, rec_pos, lig_pos, res_id, asym_id = crop_complex(
        rec_x, lig_x, rec_pos, lig_pos, crop_size, rng
    )

    R = np_random_rotation(rng)
    pos = np.concatenate([rec_pos, lig_pos])
    cen = pos[:, 1].mean(0)
    pos = (pos - cen) @ R.T
    rec_pos, lig_pos = pos[: rec_pos.shape[0]], pos[rec_pos.shape[0]:]

    b = pad_complex(
        rec_x.astype(np.float32),
        lig_x.astype(np.float32),
        rec_pos.astype(np.float32),
        lig_pos.astype(np.float32),
        pad_to=pad_to,
        res_id=res_id,
        asym_id=asym_id,
    )
    # homodimer flag (docking_dataset.py:128-140); carried, never consumed
    b["is_homomer"] = np.float32(raw["rec_seq"] == raw["lig_seq"])
    return b


def build_pool(ds, idxs, crop_size, pad_to, rng, variants: int = 2, use_esm=True):
    """Stack `variants` augmented crops of each complex into one [B, ...]
    numpy pool (B = len(idxs) * variants)."""
    batches = []
    for i in idxs:
        raw = ds.load_raw(int(i))
        for _ in range(variants):
            batches.append(make_training_batch(raw, crop_size, pad_to, rng, use_esm))
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


def upload(batch_np: dict, device) -> dict:
    """The model-facing arrays of a numpy batch or pool, on `device`."""
    return {k: torch.from_numpy(np.ascontiguousarray(batch_np[k])).to(device)
            for k in MODEL_KEYS}


def rotate_batch(batch: dict, generator: torch.Generator) -> dict:
    """A uniform SO(3) rotation of the valid rows about their CA centroid,
    drawn on the batch's device (the pool's counterpart of the host rotation
    in make_training_batch); padded rows stay at 0."""
    pos = batch["pos"]
    valid = batch["node_mask"].to(torch.float32)
    cen = (pos[:, 1] * valid[:, None]).sum(0) / valid.sum().clamp(min=1.0)
    R = random_rotation_matrix(generator, device=pos.device)
    return {**batch, "pos": ((pos - cen) @ R.T) * valid[:, None, None]}


def run_epoch(net, r3, so3, exp, opt, loss_fn, pool: dict, generator: torch.Generator,
              batch_size: int = 1, world=None) -> dict:
    """One epoch over the device pool: a random permutation of its rows,
    `batch_size` rows a step (their gradients averaged), each row rotated
    then passed to `loss_fn`.  Returns {metric: [steps] tensor} on the
    device (the mean over each step's rows).

    With `world` (a parallel.World; the pool and `generator` the same on
    every rank) each step's rows are split over the ranks in contiguous
    blocks: a rank rotates and draws its rows from its own generator
    (`World.rank_generator`) and the gradients and metrics are averaged
    over the ranks (parallel.mesh)."""
    rows = pool["x"].shape[0]
    steps = rows // batch_size
    if steps * batch_size != rows:
        raise ValueError(f"pool rows {rows} must be a multiple of batch_size {batch_size}")
    lo, hi, row_gen = 0, batch_size, generator
    if world is not None:
        if batch_size % world.size:
            raise ValueError(f"batch_size {batch_size} does not split over {world.size} ranks")
        per = batch_size // world.size
        lo, hi = world.rank * per, (world.rank + 1) * per
        row_gen = world.rank_generator(generator)
    perm = torch.randperm(rows, generator=generator, device=pool["x"].device)
    history = []
    for i in range(steps):
        history.append(train_step(
            net, r3, so3, exp, opt, loss_fn,
            [{k: v[perm[j : j + 1]][0] for k, v in pool.items()}  # no host sync
             for j in range(i * batch_size + lo, i * batch_size + hi)],
            row_gen, rotate=True, world=world))
    return {k: torch.stack([m[k] for m in history]) for k in history[0]}


def train_step(net, r3, so3, exp, opt, loss_fn, batches: list, generator, rotate=False,
               world=None):
    """One optimizer step over `batches` (one padded complex each): the
    mean of their losses' gradients, one backward per complex.  Returns
    the mean of their metrics (0-d tensors, detached).  With `world`, the
    gradients and metrics are then averaged over the ranks, each rank
    having passed its own rows."""
    opt.zero_grad(set_to_none=True)
    total = {}
    for batch in batches:
        if rotate:
            batch = rotate_batch(batch, generator)
        loss, metrics = loss_fn(net, r3, so3, batch, generator, exp)
        (loss / len(batches)).backward()
        for k, v in metrics.items():
            total[k] = total.get(k, 0.0) + v.detach() / len(batches)
    if world is not None:
        all_reduce_mean_grads(net, world)
        total = all_reduce_mean(total, world)
    opt.step()
    return total
