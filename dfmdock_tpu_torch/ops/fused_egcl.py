"""One E_GCL edge pipeline: gather, edge MLP, attention gate and K-sum.

Replaces the TPU kernel `dfmdock_tpu/ops/fused_egcl.py:fused_edge_layer`
(kernel bodies `_kernel`, `_kernel_coord`, shared `_message_chain`).  For
each node i of each pose, over its K edges (j = idx[i, k]):

  pre  = a_i + B[j] + T_sp[4 spatial bins] + T_p[relpos] + radial * w_r
  m2   = silu(silu(pre) @ W_l1 + b_l1)
  gate = sigmoid(m2 . w_att + b_att)
  agg  = sum_k valid ? gate * m2 : 0

The coord variant (last layer) continues on the gated message m2g:

  w     = clip(silu(m2g @ W_c0 + b_c0) . w_c1, -2, 2)
  trans = sum_k valid ? w * coord_diff : 0

T_sp = W_spatial @ W_e and T_p = W_relpos @ W_e are the edge-feature embed
tables pre-multiplied into the edge MLP's first layer (one-hot @ W @ W_e ==
T[bin]).  Weights come in the JAX layout [in, out].

Two precision modes, chosen by `dtype`:
- None (float32): the kernel takes both products on the tensor cores in
  three bf16 passes (f32-grade); `prepare_weight` splits W_l1 and W_c0 into
  the bf16 hi and lo pieces it streams;
- torch.bfloat16: what the TPU kernel computes (`_message_chain`,
  `_kernel_coord`): a_i, B[j], T_sp and T_p rounded to bf16, each product
  one bf16 pass with float32 accumulation (silu(pre) and W_l1, m2g and
  W_c0 rounded to bf16), while the radial term, the gate, the masked K-sum
  and the coordinate sum stay float32.

`fused_edge_layer` launches the CUDA kernel (csrc/fused_egcl.cu) of the mode
asked for on CUDA tensors and runs `fused_edge_layer_plain` on CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from dfmdock_tpu_torch.features.sixd import (
    OMEGA_OFFSET,
    PHI_OFFSET,
    SPATIAL_DIM,
    THETA_OFFSET,
    gather_rows,
)
from dfmdock_tpu_torch.ops import _build
from dfmdock_tpu_torch.ops.edge_table import (
    E_DB,
    E_OB,
    E_PB,
    E_RP,
    E_TB,
    EBIN_WIDTH,
    EGEO_WIDTH,
    G_CD,
    G_RAD,
)

MAX_K = 64  # edges per node the kernel holds (the rows of its wgmma tile)
KERNEL_C = 256  # the kernel's channel width (wgmma N and product depth)
SLICE_K = 16  # W rows per stage of the kernel's shared-memory ring


def split_bf16(x):
    """x = hi + lo + O(2^-16 |x|): hi = bf16_rn(x), lo = bf16_rn(x - hi)."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.float()).to(torch.bfloat16)


def prepare_weight(w, single: bool = False):
    """W [C, C] f32 (JAX layout [in, out]) as the kernel streams it: per
    slice of SLICE_K input rows, the hi then the lo piece of W^T (with
    `single`, the single-pass bf16 mode's, the hi piece alone) in wgmma's
    no-swizzle K-major core-matrix order, element (out n, in k) of slice
    k // SLICE_K at ((n // 8) * (SLICE_K // 8) + k % SLICE_K // 8) * 64 +
    (n % 8) * 8 + k % 8.  Returns [C // SLICE_K, 2 (1 with `single`),
    SLICE_K * C] bf16."""
    c = w.shape[0]
    pieces = []
    for piece in split_bf16(w.t())[: 1 if single else 2]:  # [n, k]
        t = piece.reshape(c // 8, 8, c // SLICE_K, SLICE_K // 8, 8)  # n8, n%8, s, kc, k%8
        pieces.append(t.permute(2, 0, 3, 1, 4).reshape(c // SLICE_K, SLICE_K * c))
    return torch.stack(pieces, 1).contiguous()


def rounding(dtype):
    """x -> x rounded to `dtype` and back to float32 (identity for None)."""
    if dtype is None:
        return lambda x: x
    if dtype != torch.bfloat16:
        raise ValueError(f"fused_edge_layer computes in float32 or bfloat16, not {dtype}")
    return lambda x: x.to(dtype).float()


def fused_edge_layer_plain(idx, edge_mask, ebin, egeo, a, B, t_sp, t_p, w_r, w_l1,
                           b_l1, w_att, b_att, coord_params=None, dtype=None):
    """Plain PyTorch version of the kernel.

    idx [P, N, K] int32 and edge_mask [P, N, K] f32, the selected edges;
    ebin [P, N, K, 5] int32 and egeo [P, N, K, 4] f32 from the edge table;
    a [P, N, C] (source projection incl. the edge-MLP bias), B [P, N, C];
    t_sp [100, C], t_p [66, C]; w_r [C]; w_l1 [C, C], b_l1 [C]; w_att [C],
    b_att [1]; coord_params (w_c0 [C, C], b_c0 [C], w_c1 [C]) or None.
    `dtype` torch.bfloat16 rounds a, B, the tables and both products'
    operands to bf16 (round to nearest; float32 sums), as the TPU kernel.
    Returns agg [P, N, C] (+ trans [P, N, 3])."""
    rn = rounding(dtype)
    bins = ebin.long()
    t_sp = rn(t_sp)
    pre = (
        rn(a)[..., :, None, :]
        + gather_rows(rn(B), idx.long())
        + t_sp[bins[..., E_DB]]
        + t_sp[OMEGA_OFFSET + bins[..., E_OB]]
        + t_sp[THETA_OFFSET + bins[..., E_TB]]
        + t_sp[PHI_OFFSET + bins[..., E_PB]]
        + rn(t_p)[bins[..., E_RP]]
        + egeo[..., G_RAD, None] * w_r
    )
    m2 = F.silu(rn(F.silu(pre)) @ rn(w_l1) + b_l1)
    gate = torch.sigmoid((m2 * w_att).sum(-1, keepdim=True) + b_att)
    m2g = m2 * gate
    valid = (edge_mask > 0.5)[..., None]
    zero = torch.zeros((), dtype=m2g.dtype, device=m2g.device)
    agg = torch.where(valid, m2g, zero).sum(-2)
    if coord_params is None:
        return agg
    w_c0, b_c0, w_c1 = coord_params
    cw = F.silu(rn(m2g) @ rn(w_c0) + b_c0)
    w = (cw * w_c1).sum(-1, keepdim=True).clamp(-2.0, 2.0)
    trans = torch.where(valid, w * egeo[..., G_CD : G_CD + 3], zero).sum(-2)
    return agg, trans


@functools.cache
def _lib():
    fn = _build.load("fused_egcl").fused_egcl_launch
    fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_edge_layer(idx, edge_mask, ebin, egeo, a, B, t_sp, t_p, w_r, w_l1, b_l1,
                     w_att, b_att, coord_params=None, dtype=None):
    """One E_GCL edge pipeline; arguments as `fused_edge_layer_plain`.  On
    CUDA tensors it launches the kernel of the mode `dtype` names (None:
    three bf16 passes; torch.bfloat16: one), or raises."""
    rounding(dtype)
    if a.device.type == "cpu":
        return fused_edge_layer_plain(idx, edge_mask, ebin, egeo, a, B, t_sp, t_p, w_r,
                                      w_l1, b_l1, w_att, b_att, coord_params, dtype)
    if a.device.type != "cuda":
        raise ValueError(f"fused_edge_layer: no kernel for device {a.device}")
    p, n, k, _ = ebin.shape
    c = a.shape[-1]
    if k > MAX_K or c != KERNEL_C:
        raise ValueError(f"fused_edge_layer kernel takes K <= {MAX_K} and C = {KERNEL_C}, "
                         f"got K={k}, C={c}")
    dev, f32 = a.device, torch.float32
    single = dtype is not None
    req = _build.require
    req(idx, "idx", torch.int32, (p, n, k), dev)
    req(edge_mask, "edge_mask", f32, (p, n, k), dev)
    req(ebin, "ebin", torch.int32, (p, n, k, EBIN_WIDTH), dev)
    req(egeo, "egeo", f32, (p, n, k, EGEO_WIDTH), dev)
    req(a, "a", f32, (p, n, c), dev)
    req(B, "B", f32, (p, n, c), dev)
    req(t_sp, "t_sp", f32, (SPATIAL_DIM, c), dev)
    req(t_p, "t_p", f32, (t_p.shape[0], c), dev)
    for name, t, shape in (("w_r", w_r, (c,)), ("w_l1", w_l1, (c, c)),
                           ("b_l1", b_l1, (c,)), ("w_att", w_att, (c,)),
                           ("b_att", b_att, (1,))):
        req(t, name, f32, shape, dev)
    a, B, t_sp, t_p, w_r, b_l1, w_att = map(_build.aligned, (a, B, t_sp, t_p, w_r, b_l1, w_att))
    agg = torch.empty((p, n, c), dtype=f32, device=dev)
    w1 = prepare_weight(w_l1, single)
    coord = coord_params is not None
    if coord:
        w_c0, b_c0, w_c1 = coord_params
        req(w_c0, "w_c0", f32, (c, c), dev)
        req(b_c0, "b_c0", f32, (c,), dev)
        req(w_c1, "w_c1", f32, (c,), dev)
        wc = prepare_weight(w_c0, single)
        b_c0, w_c1 = _build.aligned(b_c0), _build.aligned(w_c1)
        trans = torch.empty((p, n, 3), dtype=f32, device=dev)
        extra = (wc.data_ptr(), b_c0.data_ptr(), w_c1.data_ptr(), trans.data_ptr())
    else:
        extra = (None, None, None, None)
    rc = _build.launch(
        _lib(), dev,
        idx.data_ptr(), edge_mask.data_ptr(), ebin.data_ptr(), egeo.data_ptr(),
        a.data_ptr(), B.data_ptr(), t_sp.data_ptr(), t_p.data_ptr(), w_r.data_ptr(),
        w1.data_ptr(), b_l1.data_ptr(), w_att.data_ptr(), b_att.data_ptr(), *extra[:3],
        agg.data_ptr(), extra[3], p, n, k, c, int(coord), int(single),
    )
    _build.check(rc, "fused_egcl")
    counter = ("bf16_" if single else "") + ("coord_launches" if coord else "launches")
    setattr(fused_edge_layer, counter, getattr(fused_edge_layer, counter) + 1)
    return (agg, trans) if coord else agg


# launches of the kernel without / with the coord branch, in the three-pass
# float32 mode and in the single-pass bf16 mode
fused_edge_layer.launches = 0
fused_edge_layer.coord_launches = 0
fused_edge_layer.bf16_launches = 0
fused_edge_layer.bf16_coord_launches = 0
