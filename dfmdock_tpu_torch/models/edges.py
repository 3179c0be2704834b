"""Stochastic sparse graph: kNN + inverse-cubic-distance samples.

Per node, the `knn` nearest neighbours by CA distance (self included) plus
`sample_size` distinct non-neighbours drawn without replacement with
probability proportional to 1/d^3, as Gumbel-top-k (the same distribution).
Small graphs shrink the counts through the slot mask.  Mirrors
`dfmdock_tpu/models/edges.select_edges`; `torch.topk` does both selections.
"""
from __future__ import annotations

import torch

_NEG_INF = -1e30


def sample_gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=device).clamp(min=tiny)
    return -torch.log(-torch.log(u))


def select_edges(
    dist: torch.Tensor,
    node_mask: torch.Tensor,
    knn: int = 20,
    sample_size: int = 40,
    generator: torch.Generator | None = None,
    gumbel: torch.Tensor | None = None,
):
    """Neighbour sets from distances.

    Args:
      dist: [..., N, N] CA distances; node_mask: [N] bool.
      generator: draws the Gumbel noise when `gumbel` is not given.
      gumbel: optional [..., N, N] injected Gumbel noise.

    Returns idx [..., N, knn+sample_size] int32 and edge_mask (same shape,
    float32, 0 on padded slots).
    """
    n_tot = dist.shape[-1]
    valid_col = node_mask[None, :]
    n = node_mask.sum()

    masked_neg = torch.where(valid_col, -dist, torch.full_like(dist, _NEG_INF))
    knn_neg, knn_idx = torch.topk(masked_neg, knn, dim=-1)
    parts = [knn_idx]
    if sample_size > 0:
        # kNN members leave the sampling pool by distance threshold
        non_knn = masked_neg < knn_neg[..., -1:]
        logits = -3.0 * torch.log(torch.clamp(dist, min=1e-10))
        logits = torch.where(
            valid_col & non_knn, logits, torch.full_like(logits, _NEG_INF)
        )
        if gumbel is None:
            gumbel = sample_gumbel(dist.shape, generator, dist.device)
        parts.append(torch.topk(logits + gumbel, sample_size, dim=-1)[1])
    idx = torch.cat(parts, dim=-1).to(torch.int32)

    # slot validity: knn slots 0..min(n,knn)-1; sample slots 0..clip(n-knn)-1
    n_knn = torch.clamp(n, max=knn)
    n_samp = torch.clamp(n - knn, 0, sample_size)
    slot = torch.arange(knn + sample_size, device=dist.device)
    slot_ok = torch.where(slot < knn, slot < n_knn, (slot - knn) < n_samp)
    edge_mask = node_mask[:, None] & slot_ok & node_mask[idx.long()]
    return idx, edge_mask.to(torch.float32)
