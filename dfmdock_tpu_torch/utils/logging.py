"""Observability: logger, parameter counts, config dumps, profiling and an
optional wandb sink (mirrors `dfmdock_tpu/utils/logging.py`).

`profile_trace` wraps a hot section in torch.profiler (the JAX package's
jax.profiler) and writes a Chrome trace into the given directory.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import time

import torch

log = logging.getLogger("dfmdock_tpu_torch")
if not log.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("[%(asctime)s %(levelname)s] %(message)s"))
    log.addHandler(_h)
    log.setLevel(logging.INFO)

TRACE_FILE = "trace.json"


def param_counts(net: torch.nn.Module) -> dict:
    """Total / trainable / non-trainable weight counts over the state_dict
    (the frozen Fourier buffer t_embed.W is the one non-trainable entry)."""
    total = sum(v.numel() for v in net.state_dict().values())
    trainable = sum(p.numel() for p in net.parameters() if p.requires_grad)
    return {"total": total, "trainable": trainable, "non_trainable": total - trainable}


def config_tree(cfg, indent: int = 0) -> str:
    """Readable dump of a dataclass tree, one field a line."""
    lines = []
    pad = "  " * indent
    if dataclasses.is_dataclass(cfg):
        for f in dataclasses.fields(cfg):
            v = getattr(cfg, f.name)
            if dataclasses.is_dataclass(v):
                lines.append(f"{pad}{f.name}:")
                lines.append(config_tree(v, indent + 1))
            else:
                lines.append(f"{pad}{f.name}: {v}")
    else:
        lines.append(f"{pad}{cfg}")
    return "\n".join(lines)


def config_to_dict(cfg) -> dict:
    return dataclasses.asdict(cfg)


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """torch.profiler around a hot section (CPU, and CUDA when there is a
    card), written to `log_dir`/trace.json (chrome://tracing, Perfetto).
    No-op when log_dir is None."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


class StepTimer:
    """Steps/s, with an optional JSONL sink of each step's metrics."""

    def __init__(self, jsonl_path: str | None = None):
        self._t0 = time.perf_counter()
        self._steps = 0
        self._f = open(jsonl_path, "a") if jsonl_path else None

    def step(self, metrics: dict | None = None):
        self._steps += 1
        if self._f is not None:
            rec = {"step": self._steps, "t": time.time()}
            if metrics:
                rec.update({k: float(v) for k, v in metrics.items()})
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()

    @property
    def steps_per_sec(self) -> float:
        return self._steps / max(time.perf_counter() - self._t0, 1e-9)

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None


class WandbLogger:
    """Optional weights-and-biases sink: a no-op when wandb is not installed
    or WANDB_MODE=disabled."""

    def __init__(self, project: str = "dfmdock_tpu_torch", config: dict | None = None):
        self._run = None
        try:
            import wandb
        except ImportError:
            return
        if os.environ.get("WANDB_MODE") != "disabled":
            self._run = wandb.init(project=project, config=config or {})

    def log(self, metrics: dict, step: int | None = None):
        if self._run is not None:
            self._run.log(metrics, step=step)

    def finish(self):
        if self._run is not None:
            self._run.finish()
