"""The port's counterpart of the repository's `__graft_entry__.py`.

entry(device) -> (fn, example_args): one forward of the full-width mlsb
ScoreNet (seeded random weights, the kernel path) over the DB5 complex 1AVX.

dryrun_multichip(n): n gloo ranks on the CPU at tiny widths run one
data-parallel training step over a stacked batch, one pooled data-parallel
epoch (the `cli.train --dp` path) and one pose-parallel sampling run, and
assert a finite loss, parameters that moved, and gathered poses of the
right shape that differ across ranks.

  python -m dfmdock_tpu_torch.parallel.dryrun 2
"""
from __future__ import annotations

import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DRYRUN_TIMEOUT_S = 180


def entry(device="cuda"):
    from dfmdock_tpu_torch.cli.common import load_model, resolve_device
    from dfmdock_tpu_torch.config import DFMDockConfig, ModelConfig
    from dfmdock_tpu_torch.data.convert import load_npz_complex
    from dfmdock_tpu_torch.data.dataset import batch_to_tensors, complex_to_batch

    device = resolve_device(str(device))
    net = load_model(None, DFMDockConfig(model=ModelConfig.fast()), device)
    raw = load_npz_complex(os.path.join(REPO, "data", "db5_npz", "1AVX.npz"))
    batch = batch_to_tensors(complex_to_batch(raw), device)

    @torch.no_grad()
    def fn(batch, pos, t):
        return net(batch, pos, t)

    return fn, (batch, batch["pos"][None], 0.5)


def _tiny(seed: int) -> dict:
    """A 20 + 12 residue random-walk complex, padded (numpy)."""
    from dfmdock_tpu_torch.data.batching import pad_complex

    r = np.random.RandomState(seed)
    rec_ca = np.cumsum(r.randn(20, 3) * 2 + [3.8, 0, 0], axis=0)
    lig_ca = np.cumsum(r.randn(12, 3) * 2 + [3.8, 0, 0], axis=0) + [8, 4, 0]
    mk = lambda ca: np.stack([ca - [1.4, 0, 0], ca, ca + [1.5, 0, 0]], 1)
    return pad_complex(r.randn(20, 32).astype(np.float32), r.randn(12, 32).astype(np.float32),
                       mk(rec_ca).astype(np.float32), mk(lig_ca).astype(np.float32))


def _check(ok, message: str):
    if not ok:
        raise AssertionError(message)


def _max_delta(before: dict, net) -> float:
    return max(float((v - before[k]).abs().max()) for k, v in net.state_dict().items())


def _dryrun_rank(world) -> dict:
    from dfmdock_tpu_torch.config import (
        DFMDockConfig,
        DiffuserConfig,
        ModelConfig,
        R3Config,
        SamplerConfig,
        SO3Config,
    )
    from dfmdock_tpu_torch.diffusion import R3Diffuser, SO3Diffuser
    from dfmdock_tpu_torch.models import ScoreNet
    from dfmdock_tpu_torch.parallel.mesh import (
        make_dp_train_step,
        make_pose_parallel_sampler,
        stack_batches,
    )
    from dfmdock_tpu_torch.sampler import EMSampler
    from dfmdock_tpu_torch.train.losses import loss_fn
    from dfmdock_tpu_torch.train.pool import PoolStep, upload
    from dfmdock_tpu_torch.train.trainer import make_optimizer

    # the translation SDE scaled to the toy complex (max_sigma 2 A): at 30 A
    # the first step throws the 12-residue ligand out of the energy cut-off
    # and every energy is exactly 0 (see __graft_entry__.py)
    cfg = DFMDockConfig(
        model=ModelConfig(lm_embed_dim=32, node_dim=16, edge_dim=8, inner_dim=8, depth=2,
                          dropout=0.0),
        diffuser=DiffuserConfig(r3=R3Config(min_sigma=0.1, max_sigma=2.0)),
        sampler=SamplerConfig(num_steps=2, init_tr_sigma=3.0),
    )
    n = world.size
    dev = world.device
    net = ScoreNet(cfg.model).init_weights(torch.Generator().manual_seed(0)).to(dev)
    r3 = R3Diffuser(cfg.diffuser.r3)
    so3 = SO3Diffuser(SO3Config(cache_dir=os.path.join(REPO, ".cache", "igso3")))
    out = {}

    # 1) one training step, data-parallel over n complexes, gradients averaged
    opt = make_optimizer(net, cfg.experiment)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    step = make_dp_train_step(net, r3, so3, cfg.experiment, opt, loss_fn, world)
    batch = upload(stack_batches([_tiny(s) for s in range(n)]), dev)
    metrics = step(batch, torch.Generator(dev).manual_seed(1))
    out["loss"] = float(metrics["loss"])
    out["delta"] = _max_delta(before, net)
    _check(np.isfinite(out["loss"]), f"dp train step gave the loss {out['loss']}")
    _check(out["delta"] > 0.0, "the dp train step moved no parameter")

    # 1b) one pooled epoch split over the ranks: two steps of n rows
    before = {k: v.clone() for k, v in net.state_dict().items()}
    pool = upload(stack_batches([_tiny(s) for s in range(2 * n)]), dev)
    stepper = PoolStep(net, r3, so3, cfg.experiment, opt, loss_fn,
                       torch.Generator(dev).manual_seed(7), batch_size=n, world=world)
    stepper.load(pool)
    m = stepper.epoch()
    out["pool_losses"] = m["loss"].tolist()
    out["pool_delta"] = _max_delta(before, net)
    _check(len(out["pool_losses"]) == 2, f"expected 2 pooled dp steps, got {out['pool_losses']}")
    _check(np.isfinite(out["pool_losses"]).all(), f"pooled dp losses {out['pool_losses']}")
    _check(out["pool_delta"] > 0.0, "the pooled dp epoch moved no parameter")

    # 2) pose-parallel sampling: 2 poses per rank, gathered on every rank
    one = _tiny(99)
    num_poses = 2 * n
    run = make_pose_parallel_sampler(EMSampler(net.eval(), r3, so3, cfg.sampler),
                                     num_poses, world)
    res = run(upload(one, dev), torch.Generator(dev).manual_seed(2))
    pos = res["pos"].cpu().numpy()
    energies = res["energy"].cpu().numpy()
    n_pad = one["pos"].shape[0]
    _check(pos.shape == (num_poses, n_pad, 3, 3), f"gathered poses of shape {pos.shape}")
    _check(energies.shape == (num_poses,), f"gathered energies of shape {energies.shape}")
    _check(np.isfinite(pos).all() and np.isfinite(energies).all(), "non-finite poses")
    lig = one["lig_mask"] > 0
    lig_ca = pos[:, lig, 1]
    out["spread"] = float(lig_ca.std(axis=0).max())
    _check(out["spread"] > 1e-3, f"poses identical across ranks (spread {out['spread']})")
    rec = (~lig) & one["node_mask"]
    d = np.linalg.norm(pos[:, rec, 1][:, :, None] - lig_ca[:, None], axis=-1)
    out["pairs_in_range"] = (d < cfg.model.cut_off).sum(axis=(1, 2)).tolist()
    _check(min(out["pairs_in_range"]) > 0, f"pairs in range {out['pairs_in_range']}")
    _check(energies.std() > 0.0, f"energies alike across poses: {energies}")
    out["energies"] = energies.tolist()
    return out


def dryrun_multichip(n_devices: int) -> dict:
    """Run the dry run on `n_devices` gloo ranks on the CPU; returns rank 0's
    summary (and prints it)."""
    from dfmdock_tpu_torch.parallel.world import spawn

    out = spawn(_dryrun_rank, n_devices, device="cpu", timeout=DRYRUN_TIMEOUT_S)
    print(f"dryrun_multichip({n_devices}): train loss {out['loss']:.4f} (max param delta "
          f"{out['delta']:.2e}), pooled dp epoch losses "
          f"{[round(x, 4) for x in out['pool_losses']]} (delta {out['pool_delta']:.2e}), "
          f"{len(out['energies'])} poses sampled (spread {out['spread']:.2f} A, "
          f"pairs-in-range {out['pairs_in_range']}), energies "
          f"{[round(x, 3) for x in out['energies']]}")
    return out


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
