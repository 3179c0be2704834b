"""Predicted-TM score from distogram-style logits, and the TM and
distogram training losses (mirrors `dfmdock_tpu/eval/tm.py`; reference
src/utils/loss.py:19-92)."""
from __future__ import annotations

import torch


def _bin_centers(boundaries: torch.Tensor) -> torch.Tensor:
    step = boundaries[1] - boundaries[0]
    return torch.cat([boundaries, boundaries[-1:] + step]) + step / 2


def _boundaries(lo: float, hi: float, n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.linspace(lo, hi, n, dtype=torch.float32, device=like.device)


def compute_tm(logits: torch.Tensor, max_bin: int = 31, no_bins: int = 64) -> torch.Tensor:
    """[R, L, no_bins] logits -> the predicted TM score (0-d)."""
    centers = _bin_centers(_boundaries(0, max_bin, no_bins - 1, logits))
    n = max(logits.shape[0] + logits.shape[1], 19)
    d0 = 1.24 * (n - 15) ** (1.0 / 3) - 1.8
    probs = torch.softmax(logits, -1)
    tm_per_bin = 1.0 / (1.0 + centers**2 / d0**2)
    pred = (probs * tm_per_bin).sum(-1)
    return torch.maximum(pred.mean(0).max(), pred.mean(1).max())


def tm_loss(logits: torch.Tensor, sq_diff: torch.Tensor, max_bin: int = 31,
            no_bins: int = 64) -> torch.Tensor:
    """Cross-entropy of the logits against the bins of the squared errors
    (no gradient through `sq_diff`)."""
    boundaries = _boundaries(0, max_bin, no_bins - 1, logits) ** 2
    true_bins = (sq_diff.detach()[..., None] > boundaries).sum(-1)
    logp = torch.log_softmax(logits, -1)
    return -torch.gather(logp, -1, true_bins[..., None]).squeeze(-1).mean()


def distogram_loss(logits: torch.Tensor, dists: torch.Tensor, min_bin: float = 3.25,
                   max_bin: float = 50.75, no_bins: int = 64,
                   pair_mask: torch.Tensor | None = None) -> torch.Tensor:
    """64-bin distogram cross-entropy, optionally over the pairs of
    `pair_mask` only."""
    boundaries = _boundaries(min_bin, max_bin, no_bins - 1, logits) ** 2
    true_bins = (dists[..., None] ** 2 > boundaries).sum(-1)
    logp = torch.log_softmax(logits, -1)
    errors = -torch.gather(logp, -1, true_bins[..., None]).squeeze(-1)
    if pair_mask is None:
        return errors.mean()
    return (errors * pair_mask).sum() / pair_mask.sum().clamp(min=1.0)
