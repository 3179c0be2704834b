"""Network building blocks that torch.nn lacks (mirrors `dfmdock_tpu/models/modules.py`).

Parameters are nn.Linear / nn.LayerNorm where torch has them; `params.py`
maps the JAX pytree (w: [in, out]) onto them.  Initialization matches the
JAX package's effective init: every Linear weight ~ N(0, 0.02), biases 0,
norms (1, 0), Fourier features ~ N(0, 1).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-5  # torch nn.LayerNorm / PyG GraphNorm default


def compute_dtype(cfg) -> torch.dtype | None:
    """The dtype a net's cast products take (`linear`'s `dtype`):
    bfloat16 when `cfg.compute_dtype` says so, on every route (the kernel
    route's ops/fused_egcl in its single-pass bf16 mode, as the JAX
    package's Pallas kernel); else None (float32)."""
    if cfg.compute_dtype == "float32":
        return None
    return getattr(torch, cfg.compute_dtype)


def linear(x, weight, bias=None, dtype=None):
    """x W^T (+ bias) for a weight [out, in] in nn.Linear's layout; the JAX
    package's `modules.linear(p, x, dtype)`.  Without `dtype`, nn.Linear's
    float32 product.  With `dtype` (bfloat16), x and W are rounded to it
    and multiplied with a float32 result, and the float32 bias is added
    after: JAX's `preferred_element_type=float32` product.  The product of
    two bf16 values is exact in float32, so the float32 GEMM on the rounded
    values rounds only in its accumulation.  Autograd rounds the gradients
    with respect to x and W to the dtype at the casts, as JAX's transpose
    of the cast does, so the backward and a second-order backward match
    JAX's.  This cast form runs on the card too (TF32 off, torch's
    default): the bf16 GEMM with a float32 output (`torch.mm(...,
    out_dtype=)`) has no derivative there, and
    `allow_bf16_reduced_precision_reduction` changes neither form's result
    (scripts/torch_bf16_linear_probe.py)."""
    if dtype is None:
        return F.linear(x, weight, bias)
    y = F.linear(x.to(dtype).float(), weight.to(dtype).float())
    return y if bias is None else y + bias


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


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None) -> torch.Tensor:
    """Inverted dropout with its mask drawn from `generator` (train mode)."""
    if rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def pair_energy_rows(hr_c, hl, mask_c, ln_g, ln_b, w2, d_c=None, w_d=None,
                     with_grads: bool = False, dtype=None):
    """One row chunk of a pair energy head's masked sum,
    num = sum_ij m_ij w2 . silu(LN(hr_i + hl_j [+ d_ij w_d])),
    and with `with_grads` its gradients with respect to hr_c, hl (and d_c),
    written out by the chain rule (LayerNorm's backward in closed form), so
    that a caller differentiating them again (second order) goes through
    plain operations.

    hr_c [..., c, C] the chunk's rows, hl [..., N, C], mask_c [..., c, N],
    d_c [..., c, N]; ln_g, ln_b, w2, w_d [C].  `dtype` (bfloat16) casts the
    last product as `linear` does, so the gradients use the rounded w2, as
    the JAX package's gradient of its cast product does.  Returns num [...] or
    (num, d num / d hr_c [..., c, C], d num / d hl [..., N, C],
    d num / d d_c [..., c, N] or None)."""
    x = hr_c[..., :, None, :] + hl[..., None, :, :]
    if d_c is not None:
        x = x + d_c[..., None] * w_d
    xc = x - x.mean(-1, keepdim=True)
    rstd = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + LN_EPS)
    xhat = xc * rstd
    y = xhat * ln_g + ln_b
    sig = torch.sigmoid(y)
    silu = y * sig
    if dtype is not None:
        silu, w2 = silu.to(dtype).float(), w2.to(dtype).float()
    num = (silu @ w2 * mask_c).sum((-2, -1))
    if not with_grads:
        return num
    g_xhat = (mask_c[..., None] * w2) * (sig * (1.0 + y * (1.0 - sig))) * ln_g
    g_x = rstd * (g_xhat - g_xhat.mean(-1, keepdim=True)
                  - xhat * (g_xhat * xhat).mean(-1, keepdim=True))
    g_d = None if d_c is None else g_x @ w_d
    return num, g_x.sum(-2), g_x.sum(-3), g_d


def time_tensor(t, device) -> torch.Tensor:
    """A forward's t as a float32 tensor on `device`: a python float (filled
    on the device, no copy from the host, so that a captured sample may make
    it), or a [P] tensor with one t per pose."""
    if isinstance(t, torch.Tensor):
        return t.to(device=device, dtype=torch.float32)
    return torch.full((), t, dtype=torch.float32, device=device)


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
