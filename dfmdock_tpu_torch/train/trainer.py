"""AdamW training loop with flat-npz checkpoints (mirrors
`dfmdock_tpu/train/trainer.py`).

AdamW at `exp.lr` and `exp.weight_decay` (the reference trains at lr 1e-4,
wd 0; score_model_mlsb.py:267-273).  The Gaussian-Fourier time-embedding
features `t_embed.W` are frozen: they are a registered buffer of
`TimeEmbed`, not a parameter, so the optimizer never sees them (the JAX
package masks them out with optax.set_to_zero; `requires_grad=False` in the
reference).  Checkpoints are the flat "/"-keyed `weights.npz` of
`params.py`, the format `cli/common.load_model` reads, so a model trained
here docks through the dock CLI's `--ckpt`.
"""
from __future__ import annotations

import os
import time
from typing import Callable, Iterable

import numpy as np
import torch

from dfmdock_tpu_torch.config import ExperimentConfig
from dfmdock_tpu_torch.params import load_npz, to_flat
from dfmdock_tpu_torch.train.pool import train_step

WEIGHTS = "weights.npz"


def make_optimizer(net: torch.nn.Module, exp: ExperimentConfig) -> torch.optim.AdamW:
    """AdamW over every trainable parameter (t_embed.W is a buffer); on CUDA
    `capturable`, its step counts on the device, so that a captured
    training step (train/pool.PoolStep) holds the optimizer too."""
    params = [p for p in net.parameters() if p.requires_grad]
    return torch.optim.AdamW(params, lr=exp.lr, weight_decay=exp.weight_decay,
                             capturable=params[0].device.type == "cuda")


def save(net: torch.nn.Module, path: str):
    """The net's weights as a flat-dict npz at `path` (a file, or a
    directory that receives `weights.npz`)."""
    if not path.endswith(".npz"):
        os.makedirs(path, exist_ok=True)
        path = os.path.join(path, WEIGHTS)
    else:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path[: -len(".npz")] + f".{os.getpid()}.tmp.npz"
    np.savez_compressed(tmp, **to_flat(net.state_dict()))
    os.replace(tmp, path)


def load(net: torch.nn.Module, path: str) -> torch.nn.Module:
    """Load a flat-dict npz (a file, or a directory holding `weights.npz`)
    into `net`; every key must match."""
    if not path.endswith(".npz"):
        path = os.path.join(path, WEIGHTS)
    net.load_state_dict(load_npz(path))
    return net


class Trainer:
    """Host loop over batches: step, log, checkpoint the last weights
    (`ckpt_dir/weights.npz`) and the best on the validation batches
    (`ckpt_dir/best/weights.npz`)."""

    def __init__(self, net, r3, so3, exp: ExperimentConfig, loss_fn,
                 ckpt_dir: str | None = None):
        self.net = net
        self.r3 = r3
        self.so3 = so3
        self.exp = exp
        self.loss_fn = loss_fn
        self.ckpt_dir = ckpt_dir
        self.opt = make_optimizer(net, exp)

    def step(self, batches: list, generator: torch.Generator) -> dict:
        """One optimizer step over `batches` (gradient mean)."""
        return train_step(self.net, self.r3, self.so3, self.exp, self.opt, self.loss_fn,
                          batches, generator)

    def fit(self, train_batches: Iterable[dict], generator: torch.Generator,
            num_epochs: int = 1, val_batches: Iterable[dict] | None = None,
            log_every: int = 50, log_fn: Callable[[dict], None] | None = None):
        best_val = float("inf")
        step = 0
        for epoch in range(num_epochs):
            for batch in train_batches:
                metrics = self.step([batch], generator)
                step += 1
                if log_every and step % log_every == 0:
                    m = {k: float(v) for k, v in metrics.items()}
                    m.update(step=step, epoch=epoch, time=time.time())
                    (log_fn or print)(m)
            if val_batches is not None:
                val = self.evaluate(val_batches, generator)
                if self.ckpt_dir and val["loss"] < best_val:
                    best_val = val["loss"]
                    save(self.net, os.path.join(self.ckpt_dir, "best"))
            if self.ckpt_dir:
                save(self.net, self.ckpt_dir)
        return self.net

    def evaluate(self, batches: Iterable[dict], generator: torch.Generator) -> dict:
        """Mean loss terms over `batches`, the weights untouched (dedx still
        needs autograd, so gradients are taken, never applied)."""
        totals: dict[str, float] = {}
        n = 0
        for batch in batches:
            _, metrics = self.loss_fn(self.net, self.r3, self.so3, batch, generator, self.exp)
            for k, v in metrics.items():
                totals[k] = totals.get(k, 0.0) + float(v.detach())
            n += 1
        return {k: v / max(n, 1) for k, v in totals.items()}
