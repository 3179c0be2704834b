"""Shared CLI plumbing: device choice, model loading, per-complex docking."""
from __future__ import annotations

import csv
import os

import numpy as np
import torch

from dfmdock_tpu_torch.config import DFMDockConfig
from dfmdock_tpu_torch.data.dataset import batch_to_tensors, complex_to_batch
from dfmdock_tpu_torch.diffusion import R3Diffuser, SO3Diffuser
from dfmdock_tpu_torch.eval import compute_metrics
from dfmdock_tpu_torch.models import DFMDockModel, ScoreNet
from dfmdock_tpu_torch.params import load_npz
from dfmdock_tpu_torch.sampler import EMSampler


def resolve_device(name: str) -> torch.device:
    """The device to run on; CUDA unless the caller asks for the CPU.  A
    CUDA device that is not there is an error, never a quiet CPU run."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but CUDA is not available "
            "(pass --device cpu to run on the CPU)"
        )
    return device


LINEAGES = {"mlsb": ScoreNet, "dfmdock": DFMDockModel}


def load_model(ckpt: str | None, cfg: DFMDockConfig, device, seed: int = 0,
               lineage: str = "mlsb"):
    """The score model of a lineage (mlsb: ScoreNet; dfmdock: DFMDockModel)
    with seeded random weights, or the weights of a flat-dict .npz
    (params.py) when `ckpt` is given; every key must match."""
    net = LINEAGES[lineage](cfg.model).init_weights(torch.Generator().manual_seed(seed))
    if ckpt is not None:
        net.load_state_dict(load_npz(ckpt))
    return net.to(device).eval()


def build_sampler(net, cfg: DFMDockConfig) -> EMSampler:
    return EMSampler(net, R3Diffuser(cfg.diffuser.r3), SO3Diffuser(cfg.diffuser.so3),
                     cfg.sampler)


def dock_complex(sampler, raw: dict, generator, num_samples: int, device,
                 native: tuple | None = None, pad_to: int | None = None):
    """Sample `num_samples` poses of one complex; returns (per-pose records,
    results with numpy values, (R, L))."""
    batch = batch_to_tensors(complex_to_batch(raw, pad_to=pad_to), device)
    results = sampler.sample(batch, num_samples, generator)
    results = {k: v.cpu().numpy() for k, v in results.items()}
    R = int(raw["rec_x"].shape[0])
    L = int(raw["lig_x"].shape[0])
    pos = results["pos"]
    records = []
    for i in range(num_samples):
        rec = {"id": raw.get("id", "complex"), "index": str(i)}
        if native is not None:
            rec.update(compute_metrics((pos[i, :R], pos[i, R : R + L]), native))
        rec["energy"] = float(results["energy"][i])
        rec["num_clashes"] = int(results["num_clashes"][i])
        records.append(rec)
    return records, results, (R, L)


def write_csv(path: str, rows: list[dict]):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fields = {}
    for r in rows:
        for k in r:
            fields[k] = None
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(fields))
        w.writeheader()
        for r in rows:
            w.writerow(r)
