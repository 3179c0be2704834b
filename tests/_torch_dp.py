"""Rank functions of tests/test_torch_parallel.py.  The spawned ranks import
this module by name, so it imports torch and the port only (no JAX), and
everything it needs comes in as arguments."""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from dfmdock_tpu_torch.config import (
    ExperimentConfig,
    ModelConfig,
    R3Config,
    SamplerConfig,
    SO3Config,
)
from dfmdock_tpu_torch.diffusion import R3Diffuser, SO3Diffuser
from dfmdock_tpu_torch.models import ScoreNet
from dfmdock_tpu_torch.parallel.mesh import make_dp_train_step, make_pose_parallel_sampler
from dfmdock_tpu_torch.parallel.world import all_gather_cat
from dfmdock_tpu_torch.sampler import EMSampler
from dfmdock_tpu_torch.train.losses import draw_perturbation, loss_fn
from dfmdock_tpu_torch.train.pool import train_step, upload
from dfmdock_tpu_torch.train.trainer import make_optimizer

# the pose-parallel runs: (num_steps, ode); one reverse SDE step (its noise
# scale is 0 at the last step) and a short probability-flow ODE
SAMPLER_RUNS = ((1, False), (3, True))
NUM_POSES = 4
EXP = ExperimentConfig(grad_energy=True)


@contextlib.contextmanager
def deterministic():
    """Deterministic kernels where torch has them: on the CPU the backward
    of an embedding-table lookup (index_put_ with accumulate) otherwise
    adds its rows in any order, and two plain steps differ in the last bit."""
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def net_of(model_kw: dict, weights: dict) -> ScoreNet:
    net = ScoreNet(ModelConfig(**model_kw))
    net.load_state_dict(weights)
    return net


def injecting(loss, draws: list):
    """loss_fn with draws[i] injected on its i-th call."""
    calls = iter(draws)
    return lambda net, r3, so3, batch, gen, exp: loss(net, r3, so3, batch, gen, exp,
                                                      injected=next(calls))


def grads_of(net) -> dict:
    return {n: (torch.zeros_like(p) if p.grad is None else p.grad).clone()
            for n, p in net.named_parameters()}


def dp_rank(world, model_kw, weights, batch_np, rows_np, draws) -> dict:
    """Everything a rank does for the tests: the pose-parallel runs, one
    data-parallel training step over one row a rank (its draw injected),
    and the first t of a training draw from the rank's own generator."""
    out = {"sample": []}
    net = net_of(model_kw, weights).eval()
    r3 = R3Diffuser(R3Config(max_sigma=1.0))
    so3 = SO3Diffuser(SO3Config())
    for num_steps, ode in SAMPLER_RUNS:
        sampler = EMSampler(net, r3, so3, SamplerConfig(num_steps=num_steps, ode=ode))
        run = make_pose_parallel_sampler(sampler, NUM_POSES, world)
        res = run(upload(batch_np, world.device), torch.Generator().manual_seed(11))
        out["sample"].append({k: v.numpy() for k, v in res.items()})

    net = net_of(model_kw, weights).train()
    per = len(rows_np) // world.size
    mine = slice(world.rank * per, (world.rank + 1) * per)
    step = make_dp_train_step(net, R3Diffuser(R3Config()), so3, EXP, make_optimizer(net, EXP),
                              injecting(loss_fn, draws[mine]), world)
    stacked = {k: torch.from_numpy(np.stack([r[k] for r in rows_np])) for k in rows_np[0]}
    with deterministic():
        metrics = step(stacked, torch.Generator().manual_seed(3))
    out["metrics"] = {k: float(v) for k, v in metrics.items()}
    out["grads"] = grads_of(net)

    gen = world.rank_generator(torch.Generator().manual_seed(5))
    t = draw_perturbation(R3Diffuser(R3Config()), so3, EXP, gen, world.device)[0]
    out["t"] = all_gather_cat(t.reshape(1), world).tolist()
    return out


def single_step(model_kw, weights, rows_np, draws) -> tuple[dict, dict]:
    """The plain train_step over every row in one process (the reference of
    the data-parallel step): its metrics and gradients."""
    net = net_of(model_kw, weights).train()
    rows = [upload(r, torch.device("cpu")) for r in rows_np]
    with deterministic():
        metrics = train_step(net, R3Diffuser(R3Config()), SO3Diffuser(SO3Config()), EXP,
                             make_optimizer(net, EXP), injecting(loss_fn, list(draws)), rows,
                             torch.Generator().manual_seed(3))
    return {k: float(v) for k, v in metrics.items()}, grads_of(net)
