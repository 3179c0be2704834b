"""Stochastic sparse graph: kNN + inverse-cubic-distance samples.

Per node, the `knn` nearest neighbours by CA distance (self included) plus
`sample_size` distinct non-neighbours drawn without replacement with
probability proportional to 1/d^3, as Gumbel-top-k (the same distribution).
Small graphs shrink the counts through the slot mask.  Mirrors
`dfmdock_tpu/models/edges.select_edges` and `select_edges_dispatch`'s fused
route, which give the same edges: both selections go through
ops/select_topk (the kernel on CUDA tensors, two stable sorts on CPU
tensors), which breaks ties to the lower index as `lax.top_k` does.
"""
from __future__ import annotations

import torch

from dfmdock_tpu_torch.ops.select_topk import NEG_INF, select_topk


def sample_gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=device).clamp(min=tiny)
    return -torch.log(-torch.log(u))


def select_y(dist, node_mask, gumbel):
    """The select_topk kernel's sampling keys: where(valid column,
    -3 log max(d, 1e-10), -1e30) + gumbel, computed by torch so that the
    kernel only compares values."""
    logits = -3.0 * torch.log(torch.clamp(dist, min=1e-10))
    return torch.where(node_mask[None, :], logits, torch.full_like(logits, NEG_INF)) + gumbel


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
    if sample_size > 0:
        if gumbel is None:
            gumbel = sample_gumbel(dist.shape, generator, dist.device)
        y = select_y(dist, node_mask, gumbel)
    else:
        y = torch.zeros_like(dist)
    return select_topk(dist, y, node_mask, knn, sample_size)
