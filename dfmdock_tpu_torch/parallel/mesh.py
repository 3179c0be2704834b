"""Pose parallelism and data-parallel training over torch.distributed
(mirrors `dfmdock_tpu/parallel/mesh.py`).

- Inference: the poses of a complex are independent, so rank r of W docks
  the contiguous block r * P/W ... (r + 1) * P/W - 1 of the P poses, and one
  all_gather per output (fixed shapes) hands every rank all of them; rank 0
  writes the outputs.  No collective runs inside the reverse steps.
- Training: each rank takes B/W rows of a step, backpropagates the mean
  loss of its rows, and the gradients are averaged by one all_reduce over a
  flattened buffer before the optimizer step (the JAX package's XLA psum).
  DistributedDataParallel is not used: the training loss differentiates
  twice (dE/dx with create_graph, `ScoreNet.apply_train`), which DDP's
  reducer does not support.

Randomness.  What the ranks share (the start poses of a dock, the pool
permutation of an epoch) is drawn from a generator seeded alike on every
rank.  A rank's own draws (the Gumbel edges and the SDE noise of its poses;
the rotation, t and perturbations of its training rows) come from
`World.rank_generator`, seeded from (seed, rank), so ranks never repeat
each other's draws.  At world size 1 the two are one generator, the plain
path's, and a one-rank run is bit-equal to the plain one.
"""
from __future__ import annotations

import numpy as np
import torch

from dfmdock_tpu_torch.parallel.world import World, all_gather_cat
from dfmdock_tpu_torch.sampler.em import randomize_pose
from dfmdock_tpu_torch.train.pool import train_step


def make_pose_parallel_sampler(sampler, num_samples: int, world: World):
    """fn(batch, generator) -> the results of `sampler.sample(batch,
    num_samples, ...)` with every pose, on every rank, each rank having
    docked its own block of num_samples / world.size poses.

    `generator` is seeded alike on every rank: each rank draws the whole
    set of num_samples start poses from it and keeps its block, so pose i
    starts where it would start without pose parallelism.  The later draws
    come from the rank's own generator (module docstring).  The block runs
    through `sampler.sample` with its start injected (on CUDA the replay of
    the sampler's captured graph); the all_gather stays outside it."""
    if num_samples % world.size:
        raise ValueError(f"--dp needs num_samples ({num_samples}) divisible by the "
                         f"device count ({world.size})")
    per = num_samples // world.size
    block = slice(world.rank * per, (world.rank + 1) * per)

    @torch.no_grad()
    def run(batch: dict, generator: torch.Generator) -> dict:
        pos0, tr0, rot0 = randomize_pose(generator, batch["pos"], batch["lig_mask"],
                                         batch["node_mask"], sampler.cfg, num_samples)
        local = sampler.sample(batch, per, world.rank_generator(generator),
                               init=(pos0[block], tr0[block], rot0[block]))
        return {k: all_gather_cat(v, world) for k, v in local.items()}

    return run


def make_dp_train_step(net, r3, so3, exp, opt, loss_fn, world: World):
    """fn(batch, generator, rotate=False) -> metrics: one data-parallel
    optimizer step over a stacked batch ({key: [B, ...]}, B a multiple of
    the world size, the same on every rank).  Rank r takes rows
    r * B/W ... (r + 1) * B/W - 1, draws them from its own generator, and
    the gradients and metrics are averaged over the ranks: the mean over
    all B rows, as train_step over the B rows in one process."""

    def step(batch: dict, generator: torch.Generator, rotate: bool = False) -> dict:
        b = next(iter(batch.values())).shape[0]
        if b % world.size:
            raise ValueError(f"batch of {b} rows does not split over {world.size} ranks")
        per = b // world.size
        rows = [{k: v[i] for k, v in batch.items()}
                for i in range(world.rank * per, (world.rank + 1) * per)]
        return train_step(net, r3, so3, exp, opt, loss_fn, rows,
                          world.rank_generator(generator), rotate=rotate, world=world)

    return step


def stack_batches(batches: list[dict]) -> dict:
    """Stack same-shape padded complex batches along a new leading axis
    (string fields are dropped)."""
    keys = [k for k in batches[0] if not isinstance(batches[0][k], str)]
    return {k: np.stack([np.asarray(b[k]) for b in batches]) for k in keys}
