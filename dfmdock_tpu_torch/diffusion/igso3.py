"""IGSO(3) density tables: truncated-series pdf / cdf / score norms.

The port's copy of `dfmdock_tpu/diffusion/igso3.py` (host-side float64
numpy).  The cache file name is the same sha1 of the same SO3Config fields,
so both packages read the tables committed under `.cache/igso3/`; a table is
built and written only when its file is missing.
"""
from __future__ import annotations

import hashlib
import os

import numpy as np

from dfmdock_tpu_torch.config import SO3Config


def igso3_expansion(omega: np.ndarray, eps: np.ndarray, L: int = 1000) -> np.ndarray:
    """Truncated power series f(omega; eps); shapes broadcast."""
    ls = np.arange(L, dtype=np.float64)
    omega = np.asarray(omega, dtype=np.float64)[..., None]
    eps = np.asarray(eps, dtype=np.float64)[..., None]
    p = (
        (2 * ls + 1)
        * np.exp(-ls * (ls + 1) * eps**2 / 2)
        * np.sin(omega * (ls + 0.5))
        / np.sin(omega / 2)
    )
    return p.sum(axis=-1)


def igso3_score_factor(
    expansion: np.ndarray, omega: np.ndarray, eps: np.ndarray, L: int = 1000
) -> np.ndarray:
    """d/dw log f(w; eps) by the quotient rule on each series term."""
    ls = np.arange(L, dtype=np.float64)
    omega = np.asarray(omega, dtype=np.float64)[..., None]
    eps = np.asarray(eps, dtype=np.float64)[..., None]
    hi = np.sin(omega * (ls + 0.5))
    dhi = (ls + 0.5) * np.cos(omega * (ls + 0.5))
    lo = np.sin(omega / 2)
    dlo = 0.5 * np.cos(omega / 2)
    dSigma = (
        (2 * ls + 1) * np.exp(-ls * (ls + 1) * eps**2 / 2) * (lo * dhi - hi * dlo) / lo**2
    ).sum(axis=-1)
    return dSigma / (expansion + 1e-4)


def marginal_density(expansion: np.ndarray, omega: np.ndarray) -> np.ndarray:
    """Density over the angle of rotation on [0, pi]."""
    return expansion * (1 - np.cos(omega)) / np.pi


def cache_path(conf: SO3Config) -> str:
    key = hashlib.sha1(
        repr(
            (
                conf.num_omega,
                conf.num_sigma,
                conf.min_sigma,
                conf.max_sigma,
                conf.schedule,
                conf.expansion_L,
            )
        ).encode()
    ).hexdigest()[:16]
    return os.path.join(conf.cache_dir, f"igso3_{key}.npz")


class IGSO3Tables:
    """Grids over (sigma, omega), float64: discrete_omega [num_omega],
    discrete_sigma [num_sigma], pdf / cdf / score_norms [num_sigma,
    num_omega], score_scaling [num_sigma]."""

    def __init__(self, conf: SO3Config, discrete_sigma: np.ndarray):
        self.discrete_omega = np.linspace(0, np.pi, conf.num_omega + 1)[1:]
        self.discrete_sigma = np.asarray(discrete_sigma, dtype=np.float64)
        path = cache_path(conf)
        if os.path.exists(path):
            with np.load(path) as z:
                self.pdf = z["pdf"]
                self.cdf = z["cdf"]
                self.score_norms = z["score_norms"]
        else:
            self.pdf, self.cdf, self.score_norms = self._build(conf)
            os.makedirs(conf.cache_dir, exist_ok=True)
            tmp = path + f".{os.getpid()}.tmp.npz"
            np.savez(tmp, pdf=self.pdf, cdf=self.cdf, score_norms=self.score_norms)
            os.replace(tmp, path)
        self.score_scaling = np.sqrt(
            np.abs((self.score_norms**2 * self.pdf).sum(-1) / self.pdf.sum(-1))
        ) / np.sqrt(3)

    def _build(self, conf: SO3Config):
        num_omega = conf.num_omega
        omega = self.discrete_omega
        pdf = np.empty((len(self.discrete_sigma), num_omega))
        score_norms = np.empty_like(pdf)
        # chunk over sigma to bound the [chunk, num_omega, L] f64 intermediate
        chunk = max(1, int(4e8) // (num_omega * conf.expansion_L * 8))
        for s0 in range(0, len(self.discrete_sigma), chunk):
            s1 = min(s0 + chunk, len(self.discrete_sigma))
            sig = np.broadcast_to(self.discrete_sigma[s0:s1, None], (s1 - s0, num_omega))
            om = np.broadcast_to(omega[None, :], (s1 - s0, num_omega))
            exp_vals = igso3_expansion(om, sig, L=conf.expansion_L)
            pdf[s0:s1] = marginal_density(exp_vals, om)
            score_norms[s0:s1] = igso3_score_factor(exp_vals, om, sig, L=conf.expansion_L)
        cdf = pdf.cumsum(axis=-1) / num_omega * np.pi
        return pdf, cdf, score_norms
