"""Device-resident training pool (mirrors `dfmdock_tpu/train/pool.py`).

The training set is featurized once on the host (crops, chain swaps and
augmentation rotations from a `np.random.RandomState`, so a seed gives the
JAX package's pool exactly), stacked into one [B, ...] pool and uploaded
once.  An epoch is a loop over a permutation of the pool's rows, each visit
rotated on the device by a uniform SO(3) rotation drawn from the run's
`torch.Generator`; the per-step metrics stay on the device until the epoch
ends.  `PoolStep` runs the steps, on CUDA as one captured graph replayed
per step.  `batch_size` B averages the gradients of B rows per optimizer
step (the JAX package's vmap), one forward and backward after another.

Crop and chain-swap variants are baked per pool build; the training CLI
rebuilds the pool every few epochs to resample them (`--pool-refresh`).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from dfmdock_tpu_torch.data.batching import pad_complex
from dfmdock_tpu_torch.data.crop import crop_complex
from dfmdock_tpu_torch.features.residues import sequence_to_onehot
from dfmdock_tpu_torch.geom import random_rotation_matrix
from dfmdock_tpu_torch.ops import launch_counts
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


class PoolStep:
    """Training over a device pool, one optimizer step at a time, each
    reading all it needs from static buffers: the pool, the epoch's
    permutation of its rows and the step's index in it, all on the device,
    so that no step waits on the host.  The port's counterpart of the JAX
    package's `one_epoch` scan.

    A step gathers its `batch_size` rows through the permutation, rotates
    each and draws its perturbation from `generator` (`rotate_batch`, the
    loss), runs the forward and backward (the mean of the rows' gradients)
    and the optimizer, and writes its metrics into the epoch's [steps]
    history.  On CUDA the first step of each buffer shape runs eagerly on a
    side stream (the warm-up, a real step); the next is captured as one
    CUDA graph, with `generator` registered with it, and every later step
    replays that graph.  A failed capture or replay raises: there is no
    eager fallback.  On the CPU every step runs the same code eagerly,
    bit-equal to `train_step` on the same rows.

    With `world` (a parallel.World; the pool and `generator` the same on
    every rank) each step's rows are split over the ranks in contiguous
    blocks: a rank rotates and draws its rows from its own generator
    (`World.rank_generator`), and the gradients and metrics are averaged
    over the ranks (parallel.mesh) by eager collectives between two
    graphs, the forward and backward's and the optimizer's.

    `captures` and `replays` count the graphs made and run; the wrappers'
    launch counts (`ops.launch_counts`) move only when a graph is captured,
    so `captured_launches` holds what the captures counted and
    `replayed_launches` what the replays launched."""

    def __init__(self, net, r3, so3, exp, opt, loss_fn, generator: torch.Generator,
                 batch_size: int = 1, world=None, capture: bool | None = None):
        """`capture`: run the steps as captured graphs (default: on CUDA;
        False runs them eagerly there too, as a reference)."""
        self.net, self.r3, self.so3, self.exp = net, r3, so3, exp
        self.capture = capture
        self.opt, self.loss_fn, self.generator = opt, loss_fn, generator
        self.batch_size, self.world = batch_size, world
        self.lo, self.hi, self.row_gen = 0, batch_size, generator
        if world is not None:
            if batch_size % world.size:
                raise ValueError(f"batch_size {batch_size} does not split over {world.size} "
                                 "ranks")
            per = batch_size // world.size
            self.lo, self.hi = world.rank * per, (world.rank + 1) * per
            self.row_gen = world.rank_generator(generator)
        self.pool = None
        self.graphs = None
        self.captures = self.replays = 0
        self.captured_launches, self.replayed_launches = {}, {}

    def load(self, pool: dict):
        """Take a device pool: copied into the buffers where every array
        keeps its shape and dtype (the graphs stay), else held as new
        buffers (the next steps warm up and capture again)."""
        same = self.pool is not None and pool.keys() == self.pool.keys() and all(
            v.shape == self.pool[k].shape and v.dtype == self.pool[k].dtype
            for k, v in pool.items())
        if same:
            for k, v in pool.items():
                self.pool[k].copy_(v)
            return
        rows = pool["x"].shape[0]
        if rows % self.batch_size:
            raise ValueError(f"pool rows {rows} must be a multiple of batch_size "
                             f"{self.batch_size}")
        self.pool = {k: v.clone() for k, v in pool.items()}
        device = pool["x"].device
        self.perm = torch.zeros(rows, dtype=torch.long, device=device)
        self.i = torch.zeros((), dtype=torch.long, device=device)
        self.keys = self.hist = None
        self.graphs = None

    def epoch(self) -> dict:
        """One epoch over a random permutation of the pool's rows.  Returns
        {metric: [steps] tensor} on the device (each step's mean over its
        rows)."""
        for _ in range(self.start()):
            self.step()
        return self.history()

    def start(self) -> int:
        """Begin an epoch: the pool's rows permuted (drawn from `generator`),
        the step index at 0.  Returns the epoch's number of steps."""
        rows = self.perm.numel()
        self.perm.copy_(torch.randperm(rows, generator=self.generator, device=self.perm.device))
        self.i.zero_()
        return rows // self.batch_size

    def history(self) -> dict:
        """{metric: [steps] tensor} of the epoch's steps so far."""
        return {k: self.hist[:, j].clone() for j, k in enumerate(self.keys)}

    def step(self):
        """One optimizer step (the epoch's next rows)."""
        capture = self.perm.device.type == "cuda" if self.capture is None else self.capture
        if not capture:
            self._eager()
        elif self.graphs is None and self.hist is None:
            side = torch.cuda.Stream(device=self.perm.device)
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self._eager()
            torch.cuda.current_stream().wait_stream(side)
        else:
            if self.graphs is None:
                self._capture()
            self._replay()

    def _forward_backward(self):
        """The step's rows through the loss and its backward; the metrics'
        mean into `self.m` (made on the first step, as the history)."""
        base = self.i * self.batch_size
        batches = []
        for j in range(self.lo, self.hi):
            row = self.perm.index_select(0, (base + j).reshape(1))
            batches.append({k: v.index_select(0, row)[0] for k, v in self.pool.items()})
        self.opt.zero_grad(set_to_none=True)
        total = backward_rows(self.net, self.r3, self.so3, self.exp, self.loss_fn, batches,
                              self.row_gen, rotate=True)
        if self.keys is None:
            self.keys = list(total)
            self.m = torch.zeros(len(self.keys), device=self.perm.device)
            self.hist = torch.zeros(self.perm.numel() // self.batch_size, len(self.keys),
                                    device=self.perm.device)
        self.m.copy_(torch.stack([total[k] for k in self.keys]))

    def _reduce(self):
        """The ranks' mean of the gradients and metrics (with `world`)."""
        all_reduce_mean_grads(self.net, self.world)
        dist.all_reduce(self.m, op=dist.ReduceOp.SUM)
        self.m /= self.world.size

    def _record(self):
        self.hist.index_copy_(0, self.i.reshape(1), self.m[None])
        self.i += 1

    def _eager(self):
        self._forward_backward()
        if self.world is not None:
            self._reduce()
        self._record()
        self.opt.step()

    def _capture(self):
        """The step as CUDA graphs: one, or with `world` the forward and
        backward's and the optimizer's, the reduction between them eager."""
        before = launch_counts()
        if self.world is None:
            parts = [lambda: (self._forward_backward(), self._record(), self.opt.step())]
        else:
            parts = [self._forward_backward, self.opt.step]
        graphs = []
        for k, part in enumerate(parts):
            g = torch.cuda.CUDAGraph()
            if k == 0:
                g.register_generator_state(self.row_gen)
            with torch.cuda.graph(g):
                part()
            graphs.append(g)
        self.graphs = graphs
        self.captures += 1
        self._per_replay = {k: v - before[k] for k, v in launch_counts().items()
                            if v != before[k]}
        for k, v in self._per_replay.items():
            self.captured_launches[k] = self.captured_launches.get(k, 0) + v

    def _replay(self):
        self.graphs[0].replay()
        if self.world is not None:
            self._reduce()
            self._record()
            self.graphs[1].replay()
        self.replays += 1
        for k, v in self._per_replay.items():
            self.replayed_launches[k] = self.replayed_launches.get(k, 0) + v


def backward_rows(net, r3, so3, exp, loss_fn, batches: list, generator, rotate=False) -> dict:
    """The loss of each of `batches` (one padded complex each) and its
    backward, scaled by 1 / len(batches), so that the gradients accumulate
    to their mean.  Returns the mean of their metrics (0-d tensors,
    detached)."""
    total = {}
    for batch in batches:
        if rotate:
            batch = rotate_batch(batch, generator)
        loss, metrics = loss_fn(net, r3, so3, batch, generator, exp)
        (loss / len(batches)).backward()
        for k, v in metrics.items():
            total[k] = total.get(k, 0.0) + v.detach() / len(batches)
    return total


def train_step(net, r3, so3, exp, opt, loss_fn, batches: list, generator, rotate=False,
               world=None):
    """One optimizer step over `batches` (one padded complex each): the
    mean of their losses' gradients, one backward per complex.  Returns
    the mean of their metrics (0-d tensors, detached).  With `world`, the
    gradients and metrics are then averaged over the ranks, each rank
    having passed its own rows."""
    opt.zero_grad(set_to_none=True)
    total = backward_rows(net, r3, so3, exp, loss_fn, batches, generator, rotate)
    if world is not None:
        all_reduce_mean_grads(net, world)
        total = all_reduce_mean(total, world)
    opt.step()
    return total
