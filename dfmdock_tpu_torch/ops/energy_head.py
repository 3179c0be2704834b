"""Pair energy head: masked mean over receptor x ligand pairs, fused.

Replaces the TPU kernel `dfmdock_tpu/ops/energy_head.py:fused_energy`
(kernel body `_kernel`).  Per pose p:

  e_ij   = w2 . silu(LayerNorm(hr_i + hl_j))      (LN: eps 1e-5, affine g, b)
  energy = sum_ij mask_ij e_ij / (sum_ij mask_ij + 1e-6)

hr = h @ W_l0[:C], hl = h @ W_l0[C:] are the two halves of the head's first
Linear, applied to the node features before the call; the head's last
Linear has no bias.  The [N, N, C] pair tensor never materializes.

`fused_energy` launches the CUDA kernel (csrc/energy_head.cu) for CUDA
tensors and runs `fused_energy_plain` for CPU tensors.  The kernel reads
the pair mask once and evaluates only the pairs it keeps (mask != 0), which
add to both sums; the others add exactly 0.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from dfmdock_tpu_torch.data.batching import ENERGY_ROW_CHUNK
from dfmdock_tpu_torch.ops import _build

LN_EPS = 1e-5  # nn.LayerNorm's default, as the head's LayerNorm
MAX_C = 1024  # the kernel holds C / 32 channels per lane, up to 32
ROWS_PER_BLOCK = 2  # csrc/energy_head.cu kRows: one partial (num, den) per block


def fused_energy_plain(hr, hl, pair_mask, ln_g, ln_b, w2):
    """Plain PyTorch version, in row chunks so [P, N, N, C] never
    materializes.  hr, hl [P, N, C]; pair_mask [P, N, N]; ln_g, ln_b,
    w2 [C] -> [P]."""
    p, n, c = hr.shape
    num = torch.zeros(p, dtype=hr.dtype, device=hr.device)
    chunk = min(ENERGY_ROW_CHUNK, n)
    for s in range(0, n, chunk):
        pair = hr[:, s : s + chunk, None, :] + hl[:, None, :, :]
        y = F.silu(F.layer_norm(pair, (c,), ln_g, ln_b, LN_EPS))
        e = y @ w2  # [P, chunk, N]
        num = num + (e * pair_mask[:, s : s + chunk]).sum((-2, -1))
    return num / (pair_mask.sum((-2, -1)) + 1e-6)


@functools.cache
def _lib():
    fn = _build.load("energy_head").energy_head_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    return fn


def fused_energy(hr, hl, pair_mask, ln_g, ln_b, w2):
    """The pair energy of every pose; arguments as `fused_energy_plain`."""
    if hr.device.type == "cpu":
        return fused_energy_plain(hr, hl, pair_mask, ln_g, ln_b, w2)
    if hr.device.type != "cuda":
        raise ValueError(f"fused_energy: no kernel for device {hr.device}")
    p, n, c = hr.shape
    if c % 32 or c > MAX_C:
        raise ValueError(f"fused_energy kernel takes C a multiple of 32 up to "
                         f"{MAX_C}, got C={c}")
    dev, f32 = hr.device, torch.float32
    req = _build.require
    req(hr, "hr", f32, (p, n, c), dev)
    req(hl, "hl", f32, (p, n, c), dev)
    req(pair_mask, "pair_mask", f32, (p, n, n), dev)
    for name, t in (("ln_g", ln_g), ("ln_b", ln_b), ("w2", w2)):
        req(t, name, f32, (c,), dev)
    # the kernel's float4 loads: a view that starts off 16 bytes is copied
    hr, hl, pair_mask, ln_g, ln_b, w2 = map(_build.aligned, (hr, hl, pair_mask, ln_g, ln_b, w2))
    tiles = -(-n // ROWS_PER_BLOCK)
    partial = torch.empty((p, tiles, 2), dtype=f32, device=dev)  # per block: num, den
    out = torch.empty((p,), dtype=f32, device=dev)
    rc = _build.launch(
        _lib(), dev, hr.data_ptr(), hl.data_ptr(), pair_mask.data_ptr(), ln_g.data_ptr(),
        ln_b.data_ptr(), w2.data_ptr(), p, n, c, partial.data_ptr(), out.data_ptr(),
    )
    _build.check(rc, "energy_head")
    fused_energy.launches += 1
    return out


fused_energy.launches = 0
