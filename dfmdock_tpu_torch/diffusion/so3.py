"""SO(3) VE-SDE (IGSO3); mirrors `dfmdock_tpu/diffusion/so3.py`.

Rotations are axis-angle vectors [..., 3]; scores are tangent vectors at the
identity; t is a python float in [0, 1].  The IGSO3 tables are read (or
built) only when a method needs them: the sampler's reverse step does not.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from dfmdock_tpu_torch.config import SO3Config
from dfmdock_tpu_torch.diffusion.igso3 import IGSO3Tables


class SO3Diffuser:
    def __init__(self, conf: SO3Config):
        if conf.schedule != "logarithmic":
            raise ValueError(f"Unrecognized schedule {conf.schedule}")
        self.conf = conf
        self.min_sigma = conf.min_sigma
        self.max_sigma = conf.max_sigma
        self.L = conf.expansion_L
        self.discrete_sigma_np = self._sigma_np(np.linspace(0.0, 1.0, conf.num_sigma))
        self.discrete_sigma = torch.tensor(self.discrete_sigma_np, dtype=torch.float32)

    @functools.cached_property
    def tables(self) -> IGSO3Tables:
        return IGSO3Tables(self.conf, self.discrete_sigma_np)

    def _sigma_np(self, t):
        return np.log(t * np.exp(self.max_sigma) + (1 - t) * np.exp(self.min_sigma))

    def sigma(self, t: float) -> float:
        """Logarithmic sigma(t)."""
        return math.log(t * math.exp(self.max_sigma) + (1 - t) * math.exp(self.min_sigma))

    def diffusion_coef(self, t: float) -> float:
        sig = self.sigma(t)
        return math.sqrt(
            2 * (math.exp(self.max_sigma) - math.exp(self.min_sigma)) * sig / math.exp(sig)
        )

    def t_to_idx(self, t: float) -> int:
        """Index into the sigma grid (np.digitize(right=False) - 1)."""
        sig = torch.tensor(self.sigma(t), dtype=torch.float32)
        i = int(torch.searchsorted(self.discrete_sigma, sig, right=True)) - 1
        return min(max(i, 0), self.conf.num_sigma - 1)

    def _score_norm_live(self, omega: torch.Tensor, t: float) -> torch.Tensor:
        """Truncated-series d/dw log f(w; sigma(t)) in float32 on omega's device."""
        sigma = float(self.discrete_sigma[self.t_to_idx(t)])
        ls = torch.arange(self.L, dtype=torch.float32, device=omega.device)
        w = omega[..., None]
        pref = (2 * ls + 1) * torch.exp(-ls * (ls + 1) * sigma**2 / 2)
        hi = torch.sin(w * (ls + 0.5))
        lo = torch.sin(w / 2)
        exp_val = (pref * hi / lo).sum(-1)
        dhi = (ls + 0.5) * torch.cos(w * (ls + 0.5))
        dlo = 0.5 * torch.cos(w / 2)
        dsigma = (pref * (lo * dhi - hi * dlo) / lo**2).sum(-1)
        return dsigma / (exp_val + 1e-4)

    def score(self, vec: torch.Tensor, t: float, eps: float = 1e-6) -> torch.Tensor:
        """Score of IGSO3(t) at axis-angle `vec` [..., 3], as a rotation vector."""
        omega = torch.sqrt((vec * vec).sum(-1)) + eps
        if self.conf.use_cached_score:
            row = torch.tensor(self.tables.score_norms[self.t_to_idx(t)],
                               dtype=torch.float32, device=vec.device)
            grid = torch.tensor(self.tables.discrete_omega[:-1], dtype=torch.float32,
                                device=vec.device)
            norm = row[torch.searchsorted(grid, omega, right=False)]
        else:
            norm = self._score_norm_live(omega, t)
        return norm[..., None] * vec / (omega[..., None] + eps)

    def reverse_step(self, score_t, t, dt, noise_scale=1.0, ode=False, z=None):
        """One Euler-Maruyama step of the reverse SDE as a tangent update
        (geodesic random walk).  `z` is the standard-normal noise."""
        g = self.diffusion_coef(t)
        if ode:
            return 0.5 * g**2 * score_t * dt
        return g**2 * score_t * dt + g * math.sqrt(dt) * noise_scale * z
