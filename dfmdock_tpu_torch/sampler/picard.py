"""Parallel-in-time (Picard) probability-flow ODE sampler, poses batched.

Mirrors `dfmdock_tpu/sampler/picard.py`.  The sequential sampler runs its
T = num_steps score evaluations one after another; Picard iteration keeps
an estimate of the whole trajectory {x_s} and repeats

  1. all T drifts at once: one forward over T x P poses, step s's poses at
     their estimate x_s and t_s (one t per pose);
  2. the trajectory recomposed from the fixed start pose,
     x_{s+1} = modify_coords(x_s, rot_s, tr_s) (no network).

After k iterations the first k states are exact, so T iterations give the
sequential ODE trajectory; fewer trade accuracy for latency.  Each step's
edge-sampling noise is drawn once, from the generator in the order the
sequential sampler draws it, and held fixed across iterations: the fixed
point is `EMSampler.sample`'s ODE trajectory with the same generator seed.
ODE only, no clash force, integrator 'em'.  On CUDA a sample (start pose,
edge noise, the K rounds and the final forward) is the replay of one
captured graph (sampler/graph.py), as the JAX package jits it whole.
"""
from __future__ import annotations

import functools

import torch

from dfmdock_tpu_torch.config import SamplerConfig
from dfmdock_tpu_torch.geom import compose_axis_angle
from dfmdock_tpu_torch.models.edges import sample_gumbel
from dfmdock_tpu_torch.sampler.em import (
    modify_coords,
    randomize_pose,
    sample_batch,
    step_schedule,
)
from dfmdock_tpu_torch.sampler.graph import SampleGraphs


class PicardSampler:
    """Latency-mode alternative to EMSampler (probability-flow ODE only)."""

    def __init__(self, net, r3, so3, cfg: SamplerConfig, num_iters: int = 10):
        if not cfg.ode:
            raise ValueError("Picard iteration applies to the probability-flow ODE")
        if cfg.use_clash_force:
            raise ValueError("clash force not supported in Picard mode")
        if cfg.integrator != "em":
            raise ValueError("Picard is its own integration scheme; combine it with the "
                             "plain Euler drift (integrator='em'), not heun")
        if num_iters < 1:
            raise ValueError(f"num_iters must be >= 1, got {num_iters}")
        self.net = net
        self.r3 = r3
        self.so3 = so3
        self.cfg = cfg
        self.num_iters = num_iters
        self.graphs = SampleGraphs()

    @torch.no_grad()
    def sample(self, batch: dict, num_samples: int, generator: torch.Generator,
               init=None, record_trajectory: bool = False,
               capture: bool | None = None) -> dict:
        """`EMSampler.sample`'s contract: dock `num_samples` poses of one
        padded complex, `init` an optional start (pos0 [P, N, 3, 3],
        tr_update [P, 1, 3], rot_update [P, 1, 3]); the trajectory is the
        final iterate's.  On CUDA the K rounds and the final forward run as
        the replay of one captured graph (`capture` as EMSampler's)."""
        ts, _, _, _ = step_schedule(self.cfg)
        device = batch["pos"].device
        # each state's t, made outside the sample (a copy from the host)
        t_all = torch.tensor(ts, dtype=torch.float32, device=device).repeat_interleave(
            num_samples)
        inputs = {"batch": sample_batch(batch), "init": init, "t_all": t_all}
        key = ("picard", self.num_iters, num_samples, record_trajectory)
        body = functools.partial(self._body, num_samples=num_samples,
                                 record_trajectory=record_trajectory,
                                 static=self.graphs.capture_device(device))
        return self.graphs.run(self.net, key, inputs, body, generator, capture)

    def _body(self, inputs: dict, generator, num_samples: int, record_trajectory: bool,
              static: bool, warmup: bool = False) -> dict:
        """The K rounds and the final forward from `inputs` (sample's batch,
        init and each state's t), drawing from `generator`, the net's
        shared inputs static where `static`; the warm-up form runs one
        round."""
        cfg = self.cfg
        ts, dt, _, _ = step_schedule(cfg)
        T = len(ts)
        batch = self.net.prepare(inputs["batch"], static)
        init, t_all = inputs["init"], inputs["t_all"]
        lig_mask = batch["lig_mask"]
        if init is None:
            pos0, tr_u, rot_u = randomize_pose(generator, batch["pos"], lig_mask,
                                               batch["node_mask"], cfg, num_samples)
        else:
            pos0, tr_u, rot_u = init
        p, n = pos0.shape[:2]
        device = pos0.device
        # each step's edge noise, in the sequential sampler's draw order
        gumbel = None
        if self.net.cfg.sample_size > 0:
            gumbel = torch.cat([sample_gumbel((p, n, n), generator, device) for _ in ts])
        zeros = torch.zeros((p, 1, 3), device=device)

        states = pos0.expand(T, -1, -1, -1, -1)  # states[s]: the pose before step s
        for _ in range(1 if warmup else self.num_iters):
            out = self.net(batch, states.reshape(T * p, n, 3, 3), t_all, gumbel=gumbel,
                           scores_only=True)
            rot_s = out["rot_score"].reshape(T, p, 1, 3)
            tr_s = out["tr_score"].reshape(T, p, 1, 3)
            rots = [self.so3.reverse_step(rot_s[s], t, dt, ode=True) if cfg.perturb_rot
                    else zeros for s, t in enumerate(ts)]
            trs = [self.r3.reverse_step(tr_s[s], t, dt, ode=True) if cfg.perturb_tr
                   else zeros for s, t in enumerate(ts)]
            traj, pos = [], pos0
            for rot, tr in zip(rots, trs):
                pos = modify_coords(pos, lig_mask, rot, tr, cfg.center_mode)
                traj.append(pos)
            states = torch.stack([pos0] + traj[:-1])

        # the final iterate's updates, accumulated as the sequential sampler does
        for rot, tr in zip(rots, trs):
            tr_u = tr_u + tr
            rot_u = compose_axis_angle(rot_u, rot)
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
