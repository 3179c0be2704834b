"""R^3 translation VE-SDE (geometric sigma schedule); mirrors
`dfmdock_tpu/diffusion/r3.py`.  t is a python float, or in the training
half (`score_scaling`, `forward_marginal`) also a 0-d tensor."""
from __future__ import annotations

import math

import torch

from dfmdock_tpu_torch.config import R3Config


class R3Diffuser:
    def __init__(self, conf: R3Config):
        self.min_sigma = conf.min_sigma
        self.max_sigma = conf.max_sigma

    def sigma(self, t: float) -> float:
        return self.min_sigma * (self.max_sigma / self.min_sigma) ** t

    def diffusion_coef(self, t: float) -> float:
        return self.sigma(t) * math.sqrt(
            2 * (math.log(self.max_sigma) - math.log(self.min_sigma))
        )

    def score(self, tr_t: torch.Tensor, t: float) -> torch.Tensor:
        return -tr_t / self.sigma(t) ** 2

    def score_scaling(self, t):
        return 1.0 / self.sigma(t)

    def forward_marginal(self, generator: torch.Generator, t: torch.Tensor):
        """tr_t ~ N(0, sigma(t)^2 I) and its score: ([1, 3], [1, 3])."""
        z = torch.randn((1, 3), generator=generator, device=t.device)
        tr_t = self.sigma(t) * z
        return tr_t, self.score(tr_t, t)

    def reverse_step(self, score_t, t, dt, noise_scale=1.0, ode=False, z=None):
        """One reverse Euler-Maruyama step: the translation update.  `z` is
        the standard-normal noise (shape of score_t), unused under `ode`."""
        g = self.diffusion_coef(t)
        if ode:
            return 0.5 * g**2 * score_t * dt
        return g**2 * score_t * dt + g * math.sqrt(dt) * noise_scale * z
