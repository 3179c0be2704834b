"""Process groups for the port's pose and data parallelism (torch.distributed).

The JAX package runs one process over a device mesh
(`dfmdock_tpu/parallel/mesh.py`).  PyTorch's idiom is one process per
device: NCCL ranks on CUDA devices, gloo ranks on the CPU.

- `init_world(device)` opens the group of this process: from `torchrun`'s
  environment when it is set (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
  MASTER_PORT), otherwise a one-rank group in this process.
- `spawn(fn, world_size, ...)` starts `world_size` ranks, one process each
  (`torch.multiprocessing`, spawn start method), joined through a FileStore
  in a fresh temporary directory (no TCP port, so concurrent runs never
  clash), and returns rank 0's result.
- `launch(fn, device, world_size, args)` picks one of the two for a CLI.

Two NCCL ranks cannot share one GPU, so a CUDA world is never larger than
the visible device count.  On the CPU any number of gloo ranks can run,
which is how the tests exercise world sizes above 1 (the JAX package's
counterpart is `XLA_FLAGS=--xla_force_host_platform_device_count=N`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import pickle
import shutil
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

# collectives (and a group's rendezvous) give up after this long
DEFAULT_TIMEOUT = datetime.timedelta(minutes=30)
TORCHRUN_VARS = ("RANK", "WORLD_SIZE")


@dataclasses.dataclass
class World:
    """This process's place in the group: its rank, the group's size and
    the device the rank computes on."""

    rank: int
    size: int
    device: torch.device
    _generators: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def main(self) -> bool:
        """Rank 0, the one that logs and writes every output."""
        return self.rank == 0

    def rank_generator(self, generator: torch.Generator) -> torch.Generator:
        """The generator of this rank's own draws, beside `generator`, which
        is seeded alike on every rank and draws what the ranks share.  At
        world size 1 it is `generator` itself, so a one-rank run draws
        exactly what the plain path draws; above 1 it is seeded from
        (generator's seed, rank) by `rank_seed` and kept for the run."""
        if self.size == 1:
            return generator
        seed = generator.initial_seed()
        if seed not in self._generators:
            self._generators[seed] = torch.Generator(self.device).manual_seed(
                rank_seed(seed, self.rank))
        return self._generators[seed]


def rank_seed(seed: int, rank: int) -> int:
    """A 63-bit seed mixed from (seed, rank) by numpy's SeedSequence: ranks
    of one run, and runs of nearby seeds, get unrelated streams."""
    hi, lo = np.random.SeedSequence((seed, rank)).generate_state(2, np.uint32)
    return (int(hi) << 31) ^ int(lo)


def backend_for(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def rank_device(device: torch.device, local_rank: int) -> torch.device:
    """The device of the rank with this local index: cuda:local_rank (made
    current) for a CUDA run, the CPU otherwise."""
    if device.type != "cuda":
        return torch.device("cpu")
    dev = torch.device("cuda", local_rank)
    torch.cuda.set_device(dev)
    return dev


def world_size_for(device: torch.device, requested: int | None = None) -> int:
    """The number of ranks a --dp run will have, without opening a group:
    torchrun's WORLD_SIZE, else `requested`, else every visible CUDA device
    on CUDA and 1 on the CPU (at least 1)."""
    if all(v in os.environ for v in TORCHRUN_VARS):
        return int(os.environ["WORLD_SIZE"])
    if requested:
        return requested
    return max(torch.cuda.device_count(), 1) if device.type == "cuda" else 1


@contextlib.contextmanager
def init_world(device: torch.device):
    """Open this process's group and yield its World; the group is destroyed
    on exit.  Under torchrun the group is the launcher's (env://);
    otherwise it is one rank in this process, over a FileStore in a
    temporary directory that is removed afterwards."""
    if dist.is_initialized():
        raise RuntimeError("a torch.distributed process group is already open")
    tmp = None
    if all(v in os.environ for v in TORCHRUN_VARS):
        dev = rank_device(device, int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend_for(dev), init_method="env://",
                                timeout=DEFAULT_TIMEOUT)
    else:
        dev = rank_device(device, device.index or 0)
        tmp = tempfile.mkdtemp(prefix="dfmdock_world_")
        store = dist.FileStore(os.path.join(tmp, "store"), 1)
        dist.init_process_group(backend_for(dev), store=store, rank=0, world_size=1,
                                timeout=DEFAULT_TIMEOUT)
    try:
        yield World(dist.get_rank(), dist.get_world_size(), dev)
    finally:
        dist.destroy_process_group()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


def _rank_main(rank, world_size, tmp, device_type, fn, args):
    """One spawned rank: join the group, run fn(world, *args), and (rank 0)
    pickle its result for the parent."""
    device = torch.device(device_type)
    if device.type == "cpu":
        # gloo ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    dev = rank_device(device, rank)
    store = dist.FileStore(os.path.join(tmp, "store"), world_size)
    dist.init_process_group(backend_for(dev), store=store, rank=rank,
                            world_size=world_size, timeout=DEFAULT_TIMEOUT)
    try:
        out = fn(World(rank, world_size, dev), *args)
        if rank == 0:
            with open(os.path.join(tmp, "result.pkl"), "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn(fn, world_size: int, args: tuple = (), device=torch.device("cpu"),
          timeout: float | None = None):
    """Run fn(world, *args) on `world_size` ranks, one spawned process each
    (fn must be importable by name), and return rank 0's result.

    A rank that raises ends the others and re-raises here.  With `timeout`
    (seconds) a run that has not ended by then is terminated and raises
    TimeoutError; DEFAULT_TIMEOUT bounds each collective, so a rank whose
    peer died stops waiting."""
    device = torch.device(device)
    if device.type == "cuda" and world_size > torch.cuda.device_count():
        raise ValueError(f"{world_size} NCCL ranks need {world_size} CUDA devices; "
                         f"{torch.cuda.device_count()} visible (two ranks cannot "
                         "share one GPU)")
    tmp = tempfile.mkdtemp(prefix="dfmdock_spawn_")
    try:
        ctx = torch.multiprocessing.start_processes(
            _rank_main, args=(world_size, tmp, device.type, fn, args),
            nprocs=world_size, join=False, start_method="spawn")
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"{world_size} ranks did not end within {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                    p.join(10)
        # written by rank 0 of this run, into this run's own directory
        with open(os.path.join(tmp, "result.pkl"), "rb") as f:
            return pickle.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def launch(fn, device: torch.device, world_size: int | None = None, args: tuple = ()):
    """fn(world, *args) over the run's ranks; returns this process's result
    (rank 0's when the ranks are spawned here).  Under torchrun each
    launched process is one rank; otherwise one rank runs in this process
    when the world has size 1, and `spawn` starts them above 1."""
    size = world_size_for(device, world_size)
    if size == 1 or all(v in os.environ for v in TORCHRUN_VARS):
        with init_world(device) as world:
            return fn(world, *args)
    return spawn(fn, size, args, device)


def all_gather_cat(t: torch.Tensor, world: World) -> torch.Tensor:
    """Every rank's `t` (equal shapes) concatenated along dim 0, in rank
    order, on every rank."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(world.size)]
    dist.all_gather(parts, t)
    return torch.cat(parts)


def all_reduce_mean_grads(net: torch.nn.Module, world: World):
    """Average the gradients of `net`'s trainable parameters over the ranks:
    one flattened buffer, all_reduce(SUM), divided by the world size (the
    XLA psum of the JAX package's data-parallel step).  A parameter the loss
    did not reach on a rank counts there as a zero gradient, and keeps no
    gradient where it reached none on any rank (as in the plain step, so
    the optimizer skips it alike)."""
    params = [p for p in net.parameters() if p.requires_grad]
    has = torch.tensor([p.grad is not None for p in params], dtype=torch.float32,
                       device=params[0].device)
    flat = torch.cat([(torch.zeros_like(p) if p.grad is None else p.grad).reshape(-1)
                      for p in params] + [has])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    reached = (flat[-len(params):] > 0).tolist()
    flat = flat[: -len(params)] / world.size
    offset = 0
    for p, r in zip(params, reached):
        n = p.numel()
        mean = flat[offset : offset + n].view_as(p)
        if not r:
            p.grad = None
        elif p.grad is None:
            p.grad = mean.clone()
        else:  # in place: a captured optimizer step reads the gradients' buffers
            p.grad.copy_(mean)
        offset += n


def all_reduce_mean(metrics: dict, world: World) -> dict:
    """The mean over the ranks of a dict of 0-d tensors."""
    keys = sorted(metrics)
    flat = torch.stack([metrics[k].to(torch.float32) for k in keys])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    flat /= world.size
    return {k: v.to(metrics[k].dtype) for k, v in zip(keys, flat.unbind())}
