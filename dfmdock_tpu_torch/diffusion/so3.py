"""SO(3) VE-SDE (IGSO3); mirrors `dfmdock_tpu/diffusion/so3.py`.

Rotations are axis-angle vectors [..., 3]; scores are tangent vectors at the
identity.  The sampler's methods take t as a python float in [0, 1]; the
training half (`sample_igso3`, `sample`, `score_scaling`,
`forward_marginal`) also takes a 0-d tensor on the device, so a training
step draws t there without a host round trip, and draws its randomness from
a `torch.Generator`.  The IGSO3 tables are read (or built) only when a
method needs them: the sampler's reverse step does not.
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
        self._grids = {}

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

    def t_to_idx(self, t):
        """Index into the sigma grid (np.digitize(right=False) - 1): an int
        for a float t; for a tensor t a [1] long tensor on its device, which
        indexes without a host round trip."""
        if isinstance(t, torch.Tensor):
            grid = self._grid(t.device)["sigma"]
            sig = torch.log(t * math.exp(self.max_sigma) + (1 - t) * math.exp(self.min_sigma))
            i = torch.searchsorted(grid, sig.float().reshape(1), right=True) - 1
            return i.clamp(0, self.conf.num_sigma - 1)
        sig = torch.tensor(self.sigma(t), dtype=torch.float32)
        i = int(torch.searchsorted(self.discrete_sigma, sig, right=True)) - 1
        return min(max(i, 0), self.conf.num_sigma - 1)

    def _grid(self, device) -> dict:
        """The float32 grids a training step reads, on `device` (made once)."""
        key = str(device)
        if key not in self._grids:
            f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
            self._grids[key] = {
                "sigma": self.discrete_sigma.to(device),
                "omega": f32(self.tables.discrete_omega),
                "cdf": f32(self.tables.cdf),
                "score_scaling": f32(self.tables.score_scaling),
            }
        return self._grids[key]

    def _score_norm_live(self, omega: torch.Tensor, t) -> torch.Tensor:
        """Truncated-series d/dw log f(w; sigma(t)) in float32 on omega's device."""
        if isinstance(t, torch.Tensor):
            sigma = self._grid(omega.device)["sigma"][self.t_to_idx(t)][0]
        else:
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

    def score_scaling(self, t):
        """RMS score norm / sqrt(3) at t, which normalizes the training
        losses; t a float (-> float) or a 0-d tensor (-> tensor)."""
        if isinstance(t, torch.Tensor):
            return self._grid(t.device)["score_scaling"][self.t_to_idx(t)][0]
        return float(self.tables.score_scaling[self.t_to_idx(t)])

    def sample_igso3(self, generator: torch.Generator, t: torch.Tensor,
                     n_samples: int = 1) -> torch.Tensor:
        """Inverse-CDF samples of the rotation angle under IGSO3(t) [n]:
        uniform draws interpolated through the cdf row of t (np.interp
        semantics, as jnp.interp)."""
        grid = self._grid(t.device)
        u = torch.rand((n_samples,), generator=generator, device=t.device)
        return interp(u, grid["cdf"][self.t_to_idx(t)][0], grid["omega"])

    def sample(self, generator: torch.Generator, t: torch.Tensor,
               n_samples: int = 1) -> torch.Tensor:
        """Axis-angle samples from IGSO3(t) [n, 3]: a uniform axis times a
        sampled angle."""
        x = torch.randn((n_samples, 3), generator=generator, device=t.device)
        x = x / torch.linalg.norm(x, dim=-1, keepdim=True)
        return x * self.sample_igso3(generator, t, n_samples)[:, None]

    def forward_marginal(self, generator: torch.Generator, t: torch.Tensor):
        """A forward perturbation at t and its score: (rot_t [1, 3],
        rot_score [1, 3])."""
        sampled = self.sample(generator, t, 1)
        return sampled, self.score(sampled, t)

    def reverse_step(self, score_t, t, dt, noise_scale=1.0, ode=False, z=None):
        """One Euler-Maruyama step of the reverse SDE as a tangent update
        (geodesic random walk).  `z` is the standard-normal noise."""
        g = self.diffusion_coef(t)
        if ode:
            return 0.5 * g**2 * score_t * dt
        return g**2 * score_t * dt + g * math.sqrt(dt) * noise_scale * z


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """np.interp / jnp.interp of x on the increasing grid xp: linear between
    the grid points, fp[0] below and fp[-1] above, the left value where two
    grid points coincide."""
    i = torch.searchsorted(xp, x, right=True).clamp(1, xp.shape[0] - 1)
    x0, x1, f0, f1 = xp[i - 1], xp[i], fp[i - 1], fp[i]
    dx = x1 - x0
    flat = dx.abs() <= torch.finfo(xp.dtype).eps * torch.finfo(xp.dtype).eps
    f = torch.where(flat, f0, f0 + (x - x0) / torch.where(flat, 1.0, dx) * (f1 - f0))
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)
