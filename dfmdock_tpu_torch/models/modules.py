"""Network building blocks that torch.nn lacks (mirrors `dfmdock_tpu/models/modules.py`).

Parameters are nn.Linear / nn.LayerNorm where torch has them; `params.py`
maps the JAX pytree (w: [in, out]) onto them.  Initialization matches the
JAX package's effective init: every Linear weight ~ N(0, 0.02), biases 0,
norms (1, 0), Fourier features ~ N(0, 1).
"""
from __future__ import annotations

import math

import torch
from torch import nn

LN_EPS = 1e-5  # torch nn.LayerNorm / PyG GraphNorm default


class GraphNorm(nn.Module):
    """PyG GraphNorm over one masked graph per leading index:
    out = g * (x - mean * mean_scale) / sqrt(var + eps) + b, with mean/var
    over the valid nodes only."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.mean_scale = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor, node_mask: torch.Tensor) -> torch.Tensor:
        """x [..., N, C], node_mask [N] bool."""
        m = node_mask.to(x.dtype)[:, None]
        count = m.sum().clamp(min=1.0)
        mean = (x * m).sum(-2, keepdim=True) / count
        shifted = x - mean * self.mean_scale
        var = ((shifted * shifted) * m).sum(-2, keepdim=True) / count
        return self.weight * shifted * torch.rsqrt(var + LN_EPS) + self.bias


def gaussian_fourier(W: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """t [...] -> [..., 2 * len(W)]: concat(sin, cos) of 2*pi*W*t."""
    x_proj = t[..., None] * W * (2 * math.pi)
    return torch.cat([torch.sin(x_proj), torch.cos(x_proj)], dim=-1)


class TimeEmbed(nn.Module):
    """sigmoid(fourier(t) @ l0): the fixed random features `W` ride in the
    state dict as a buffer (frozen, as in the JAX package)."""

    def __init__(self, inner_dim: int):
        super().__init__()
        self.register_buffer("W", torch.zeros(inner_dim // 2))
        self.l0 = nn.Linear(inner_dim, inner_dim, bias=False)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        """t [] or [T] -> [T, inner_dim] (T = 1 for a scalar t)."""
        return torch.sigmoid(self.l0(gaussian_fourier(self.W, t.reshape(-1))))


def time_tensor(t, device) -> torch.Tensor:
    """A forward's t as a float32 tensor on `device`: a python float, or a
    [P] tensor with one t per pose."""
    return torch.as_tensor(t, dtype=torch.float32, device=device)


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator, std: float = 0.02):
    """Seeded init of a module tree (on the CPU, so every device gets the
    same weights for a seed)."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator) * std)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, GraphNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.mean_scale.fill_(1.0)
        elif isinstance(m, TimeEmbed):
            m.W.copy_(torch.randn(m.W.shape, generator=generator))
