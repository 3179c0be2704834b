"""Euler-Maruyama reverse-SDE pose sampler, poses batched on a leading axis.

Mirrors `dfmdock_tpu/sampler/em.py` (EMSampler.sample / sample_one): a random
start pose per pose, `num_steps` reverse steps that each call the ScoreNet
with `scores_only` (integrator 'em', or 'heun': a second-order step on the
probability-flow ODE), an optional clash-force nudge after each step, one
full forward at the final pose, ranking by energy.  Randomness comes from
one torch.Generator; `init` and `noise` inject the start pose and the step
noise instead.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from dfmdock_tpu_torch.config import SamplerConfig
from dfmdock_tpu_torch.diffusion import R3Diffuser, SO3Diffuser
from dfmdock_tpu_torch.geom import axis_angle_to_matrix, compose_axis_angle, matrix_to_axis_angle
from dfmdock_tpu_torch.geom.rotations import quaternion_to_matrix
from dfmdock_tpu_torch.sampler.graph import SampleGraphs


def _lig_center(pos, lig_mask, mode: str):
    """Ligand centroid [..., 3] of pos [..., N, 3, 3]: 'ca' = CA mean,
    'bb' = all-backbone-atom mean."""
    n = lig_mask.sum().clamp(min=1.0)
    if mode == "bb":
        return (pos * lig_mask[:, None, None]).sum((-3, -2)) / (3.0 * n)
    return (pos[..., 1, :] * lig_mask[:, None]).sum(-2) / n


def _rotate_ligand(pos, lig_mask, rot, center, shift):
    """Rows with lig_mask: (x - center) @ rot^T + center + shift.
    pos [P|1, N, 3, 3], rot [P, 3, 3], center / shift [P|1, 3]."""
    x = (pos - center[:, None, None, :]).expand(rot.shape[0], -1, -1, -1)
    new_lig = torch.einsum("pnad,ped->pnae", x, rot) + (center + shift)[:, None, None, :]
    return torch.where(lig_mask[:, None, None] > 0, new_lig, pos)


def randomize_pose(generator, pos, lig_mask, node_mask, cfg: SamplerConfig,
                   num_samples: int):
    """Random start poses: uniform SO(3) rotation of the ligand about its
    centroid + N(0, init_tr_sigma) translation to near the receptor centroid.
    Draws a Gaussian quaternion [P, 4], then the translation's standard
    normals [P, 1, 3], from `generator` (`place_pose` does the rest).

    pos [N, 3, 3] -> (pos [P, N, 3, 3], tr_update [P, 1, 3], rot_update [P, 1, 3])."""
    quat = torch.randn((num_samples, 4), generator=generator, device=pos.device)
    noise = torch.randn((num_samples, 1, 3), generator=generator, device=pos.device)
    return place_pose(pos, lig_mask, node_mask, cfg, quat, noise)


def place_pose(pos, lig_mask, node_mask, cfg: SamplerConfig, quat, noise):
    """The start poses of `randomize_pose` from given draws: quat [P, 4]
    Gaussian quaternions (the rotation, Haar-uniform once normalized) and
    noise [P, 1, 3] standard normals (the translation), as the JAX package's
    `randomize_pose` draws them from its keys."""
    valid = node_mask.to(torch.float32)
    lig = lig_mask * valid
    rec = (1.0 - lig_mask) * valid
    c2 = _lig_center(pos, lig, cfg.center_mode)
    c1 = _lig_center(pos, rec, cfg.center_mode)
    rot = quaternion_to_matrix(quat)
    tr_update = noise * cfg.init_tr_sigma - c2 + c1
    new = _rotate_ligand(pos[None], lig, rot, c2[None], tr_update[:, 0])
    return new, tr_update, matrix_to_axis_angle(rot)[:, None, :]


def modify_coords(pos, lig_mask, rot_aa, tr, mode: str = "ca"):
    """Rigid update of ligand rows about the ligand centroid.
    pos [P, N, 3, 3], rot_aa / tr [P, 1, 3]."""
    center = _lig_center(pos, lig_mask, mode)
    return _rotate_ligand(pos, lig_mask, axis_angle_to_matrix(rot_aa[:, 0]), center, tr[:, 0])


def clash_force(pos, lig_mask, node_mask):
    """Repulsion-gradient translation nudging clashing ligands apart
    (inference_base.py:366-384): rep(d) = |4 - d|^1.5 / (1.5 * d * 0.5) for
    d < 4 A over all receptor x ligand backbone-atom pairs; the force is the
    gradient of -5 * sum(rep) with respect to the ligand atoms, averaged
    over them.  pos [..., N, 3, 3] -> [..., 3]."""
    valid = node_mask.to(torch.float32)
    per_atom = lambda w: w[:, None].expand(-1, 3).reshape(-1)  # each row's 3 atoms
    lig_w = per_atom(lig_mask * valid)
    rec_w = per_atom((1.0 - lig_mask) * valid)
    atoms = pos.detach().reshape(*pos.shape[:-3], -1, 3)
    with torch.enable_grad():
        lig_atoms = atoms.clone().requires_grad_(True)
        diff = atoms[..., :, None, :] - lig_atoms[..., None, :, :]
        d = torch.sqrt(torch.clamp((diff * diff).sum(-1), min=1e-12))
        x0, p, w_rep = 4.0, 1.5, 5.0
        rep = torch.where(d < x0, (x0 - d).abs() ** p / (p * d * (p - 1)),
                          torch.zeros_like(d))
        rep = rep * rec_w[:, None] * lig_w[None, :]
        (grad,) = torch.autograd.grad(-w_rep * rep.sum(), lig_atoms)
    return (grad * lig_w[:, None]).sum(-2) / lig_w.sum().clamp(min=1.0)


def sample_batch(batch: dict) -> dict:
    """The tensors of `batch` that a sample reads (the padded complex, and
    what the net's `prepare` made, where given): a captured sample's static
    inputs."""
    return {k: v for k, v in batch.items() if isinstance(v, (torch.Tensor, tuple))}


def step_schedule(cfg: SamplerConfig):
    """The sampler's (ts, dt, tr_noise_scales, rot_noise_scales), python floats."""
    ts = torch.linspace(1.0, cfg.eps, cfg.num_steps, dtype=torch.float32).tolist()
    dt = ts[0] - ts[1] if len(ts) > 1 else 0.0  # one step: JAX's clamped index
    if cfg.noise_annealing:
        return ts, dt, list(ts), list(ts)
    tr_ns = [cfg.tr_noise_scale] * (cfg.num_steps - 1) + [0.0]
    rot_ns = [cfg.rot_noise_scale] * (cfg.num_steps - 1) + [0.0]
    return ts, dt, tr_ns, rot_ns


class EMSampler:
    """Reverse-SDE docking sampler over a ScoreNet.  On CUDA each sample runs
    as the replay of one captured CUDA graph per shape key (sampler/graph.py);
    on the CPU it runs eagerly, the same body."""

    def __init__(self, net, r3: R3Diffuser, so3: SO3Diffuser, cfg: SamplerConfig):
        if cfg.integrator not in ("em", "heun"):
            raise ValueError(f"unknown integrator {cfg.integrator!r}")
        if cfg.integrator == "heun" and not cfg.ode:
            raise ValueError("the Heun integrator runs on the probability-flow ODE (ode=True)")
        self.net = net
        self.r3 = r3
        self.so3 = so3
        self.cfg = cfg
        self.graphs = SampleGraphs()

    @torch.no_grad()
    def sample(self, batch: dict, num_samples: int, generator: torch.Generator,
               init=None, noise=None, record_trajectory: bool = False,
               capture: bool | None = None) -> dict:
        """Dock `num_samples` poses of one padded complex.

        init: optional (pos0 [P, N, 3, 3], tr_update [P, 1, 3], rot_update
        [P, 1, 3]) in place of the random start.  noise: optional (z_rot,
        z_tr), each [num_steps, P, 1, 3] standard normals, in place of the
        generator's step noise.  capture: run the sample as a captured CUDA
        graph (default: on CUDA tensors; True on CPU tensors raises; False
        runs it eagerly on the card too, for callers that hook the forward
        in Python).

        Returns pos [P, N, 3, 3], tr_update / rot_update / tr_score /
        rot_score [P, 1, 3], energy [P], num_clashes [P] (+ trajectory
        [P, num_steps, N, 3, 3], the pose after every step)."""
        inputs = {"batch": sample_batch(batch), "init": init, "noise": noise}
        key = ("em", num_samples, record_trajectory)
        body = functools.partial(self._body, num_samples=num_samples,
                                 record_trajectory=record_trajectory,
                                 static=self.graphs.capture_device(batch["pos"].device))
        return self.graphs.run(self.net, key, inputs, body, generator, capture)

    def _body(self, inputs: dict, generator, num_samples: int, record_trajectory: bool,
              static: bool, warmup: bool = False) -> dict:
        """The whole sample from `inputs` (sample's batch, init and noise),
        drawing from `generator`, the net's shared inputs in their static
        form where `static`; the warm-up form runs the first step and the
        final forward."""
        cfg = self.cfg
        ts, dt, tr_ns, rot_ns = step_schedule(cfg)
        batch = self.net.prepare(inputs["batch"], static)
        init, noise = inputs["init"], inputs["noise"]
        lig_mask = batch["lig_mask"]
        if init is None:
            pos, tr_u, rot_u = randomize_pose(generator, batch["pos"], lig_mask,
                                              batch["node_mask"], cfg, num_samples)
        else:
            pos, tr_u, rot_u = init
        shape = (num_samples, 1, 3)
        zeros = torch.zeros(shape, device=pos.device)

        def normal(s, which):
            if cfg.ode:
                return None
            if noise is not None:
                return noise[which][s]
            return torch.randn(shape, generator=generator, device=pos.device)

        def updates(out, t, s, z_rot, z_tr):
            rot = (self.so3.reverse_step(out["rot_score"], t, dt, rot_ns[s], cfg.ode, z_rot)
                   if cfg.perturb_rot else zeros)
            tr = (self.r3.reverse_step(out["tr_score"], t, dt, tr_ns[s], cfg.ode, z_tr)
                  if cfg.perturb_tr else zeros)
            return rot, tr

        traj = []
        for s, t in enumerate(ts[:1] if warmup else ts):
            out = self.net(batch, pos, t, generator=generator, scores_only=True)
            z_rot, z_tr = normal(s, 0), normal(s, 1)
            rot, tr = updates(out, t, s, z_rot, z_tr)
            if cfg.integrator == "heun":
                # corrector drift from the Euler-predicted pose at t - dt
                # (float32, as the JAX schedule), increments averaged in the
                # tangent space
                t2 = float(max(np.float32(t) - np.float32(dt), np.float32(cfg.eps)))
                pos2 = modify_coords(pos, lig_mask, rot, tr, cfg.center_mode)
                out2 = self.net(batch, pos2, t2, generator=generator, scores_only=True)
                rot2, tr2 = updates(out2, t2, s, z_rot, z_tr)
                rot, tr = 0.5 * (rot + rot2), 0.5 * (tr + tr2)
            pos = modify_coords(pos, lig_mask, rot, tr, cfg.center_mode)
            tr_u = tr_u + tr
            rot_u = compose_axis_angle(rot_u, rot)
            if cfg.use_clash_force:
                force = clash_force(pos, lig_mask, batch["node_mask"])
                pos = torch.where(lig_mask[:, None, None] > 0,
                                  pos + force[:, None, None, :], pos)
                tr_u = tr_u + force[:, None, :]
            if record_trajectory:
                traj.append(pos)

        out = self.net(batch, pos, ts[-1], generator=generator)
        result = {
            "pos": pos,
            "tr_update": tr_u,
            "rot_update": rot_u,
            "energy": out["energy"],
            "num_clashes": out["num_clashes"],
            "tr_score": out["tr_score"],
            "rot_score": out["rot_score"],
        }
        if record_trajectory:
            result["trajectory"] = torch.stack(traj, 1)
        return result

    @staticmethod
    def rank_by_energy(results) -> int:
        """Index of the minimum-energy pose."""
        return int(torch.argmin(results["energy"]))
