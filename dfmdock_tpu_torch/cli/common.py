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


DP_HELP = ("split the poses over the ranks of torch.distributed: one NCCL rank per "
           "visible GPU, or --world-size gloo ranks on the CPU; num-samples must "
           "divide by the number of ranks")
WORLD_SIZE_HELP = ("--dp ranks (default: every visible GPU on cuda, 1 on the CPU); on "
                   "the CPU, N gloo ranks, the JAX package's "
                   "XLA_FLAGS=--xla_force_host_platform_device_count=N")

LINEAGES = {"mlsb": ScoreNet, "dfmdock": DFMDockModel}


def load_model(ckpt: str | None, cfg: DFMDockConfig, device, seed: int = 0,
               lineage: str = "mlsb"):
    """The score model of a lineage (mlsb: ScoreNet; dfmdock: DFMDockModel)
    with seeded random weights, or the weights of `ckpt`: a flat-dict .npz
    (params.py), or a reference Lightning .ckpt (utils/torch_convert.py;
    trusted files only, since it is unpickled).  Every key must match."""
    net = LINEAGES[lineage](cfg.model).init_weights(torch.Generator().manual_seed(seed))
    if ckpt is not None and ckpt.endswith(".ckpt"):
        from dfmdock_tpu_torch.utils.torch_convert import load_lightning_checkpoint

        net.load_state_dict(load_lightning_checkpoint(ckpt, lineage=lineage)[0])
    elif ckpt is not None:
        net.load_state_dict(load_npz(ckpt))
    return net.to(device).eval()


def build_sampler(net, cfg: DFMDockConfig) -> EMSampler:
    return EMSampler(net, R3Diffuser(cfg.diffuser.r3), SO3Diffuser(cfg.diffuser.so3),
                     cfg.sampler)


def add_dp_arguments(ap, dp_help: str = DP_HELP):
    ap.add_argument("--dp", action="store_true", help=dp_help)
    ap.add_argument("--world-size", type=int, default=None, help=WORLD_SIZE_HELP)


def dp_world_size(ap, args) -> int | None:
    """The number of --dp ranks (None without --dp), for the parse-time
    checks; refuses --world-size without --dp."""
    if not args.dp:
        if args.world_size is not None:
            ap.error("--world-size applies to --dp")
        return None
    from dfmdock_tpu_torch.parallel import world_size_for

    return world_size_for(torch.device(args.device), args.world_size)


def check_dp_samples(ap, args):
    """Refuse a --dp run whose --num-samples the number of ranks does not
    divide (the JAX package's make_runner refusal)."""
    n_dev = dp_world_size(ap, args)
    if n_dev is not None and args.num_samples % n_dev:
        ap.error(f"--dp needs num_samples ({args.num_samples}) divisible by the "
                 f"device count ({n_dev})")


def make_runner(sampler, num_samples: int, world=None):
    """Pose runner: (batch, generator) -> results with a leading pose axis.

    With `world` (a parallel.World: a --dp run) the poses are split over
    the ranks and gathered (parallel.mesh.make_pose_parallel_sampler, which
    refuses a num_samples the world size does not divide); without, they
    run batched on this process's device.  The CLIs build one runner (and
    one sampler) a run: on CUDA the sampler keeps one captured graph per
    padded N, so the jobs of one N replay one graph."""
    if world is not None:
        from dfmdock_tpu_torch.parallel.mesh import make_pose_parallel_sampler

        return make_pose_parallel_sampler(sampler, num_samples, world)
    return lambda batch, generator: sampler.sample(batch, num_samples, generator)


def dock_complex(sampler, raw: dict, generator, num_samples: int, device,
                 native: tuple | None = None, pad_to: int | None = None, run_fn=None):
    """Sample `num_samples` poses of one complex (through `run_fn`, a
    make_runner runner, when given); returns (per-pose records, results
    with numpy values, (R, L))."""
    batch = batch_to_tensors(complex_to_batch(raw, pad_to=pad_to), device)
    if run_fn is None:
        results = sampler.sample(batch, num_samples, generator)
    else:
        results = run_fn(batch, generator)
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
