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

Two precision modes, chosen by `dtype`, each its own kernel:
- None (float32): the kernel takes both products on the tensor cores in
  three bf16 passes (f32-grade); `prepare_weight` splits W_l1 and W_c0 into
  the bf16 hi and lo pieces it streams;
- torch.bfloat16: what the TPU kernel computes (`_message_chain`,
  `_kernel_coord`): a_i, B[j], T_sp and T_p rounded to bf16, each product
  one bf16 pass with float32 accumulation (silu(pre) and W_l1, m2g and
  W_c0 rounded to bf16), while the radial term, the gate, the masked K-sum
  and the coordinate sum stay float32.  Its kernel reads B as bf16 (a
  float32 B is rounded on the way in), the tables as one bf16 array and
  the weights as `prepare_weight_bf16` lays them out.

The kernel reads t_sp, t_p, W_l1 and W_c0 in their kernel-side form
(`prepare_layer`), which does not change between calls with the same
weights: a caller builds it once and passes it as `prepared`
(models/egnn.egnn_apply_fused does).  `fused_edge_layer` launches the CUDA
kernel (csrc/fused_egcl.cu) of the mode asked for on CUDA tensors, from
`prepared` alone, and runs `fused_edge_layer_plain` on CPU tensors, from the
raw operands alone.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from dfmdock_tpu_torch.features.positional import NUM_RELPOS_CLASSES
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

MAX_K = 64  # edges per node the kernels hold (the rows of their wgmma tile)
KERNEL_C = 256  # the kernels' channel width (wgmma N and product depth)
SLICE_K = 16  # W rows per stage of the three-pass kernel's shared-memory ring
SLICE_K_BF16 = 32  # W rows per stage of the bf16 kernel's ring
TABLE_ROWS = SPATIAL_DIM + NUM_RELPOS_CLASSES  # the bf16 kernel's tables: T_sp, then T_p


def split_bf16(x):
    """x = hi + lo + O(2^-16 |x|): hi = bf16_rn(x), lo = bf16_rn(x - hi)."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.float()).to(torch.bfloat16)


def core_layout(wt, slice_k):
    """wt [n, k] (W^T: out n, in k) as wgmma's no-swizzle K-major core
    matrices, per slice of `slice_k` input rows: element (n, k) of slice
    k // slice_k at ((n // 8) * (slice_k // 8) + k % slice_k // 8) * 64 +
    (n % 8) * 8 + k % 8.  Returns [k // slice_k, slice_k * n]."""
    n, k = wt.shape
    t = wt.reshape(n // 8, 8, k // slice_k, slice_k // 8, 8)  # n8, n%8, s, kc, k%8
    return t.permute(2, 0, 3, 1, 4).reshape(k // slice_k, slice_k * n)


def prepare_weight(w):
    """W [C, C] f32 (JAX layout [in, out]) as the three-pass kernel streams
    it: per slice of SLICE_K input rows, the hi then the lo piece of W^T in
    `core_layout`'s order.  Returns [C // SLICE_K, 2, SLICE_K * C] bf16."""
    return torch.stack([core_layout(p, SLICE_K) for p in split_bf16(w.t())], 1).contiguous()


def _build_order():
    """The bf16 kernel's thread q builds the eight columns 8 q + u of each
    32-column slice with one 16-byte load per row; its A fragment holds them
    at k-step u // 4, column 8 (u // 2 % 2) + 2 q + u % 2.  Entry L: the
    slice column that sits at fragment position L (16 x k-step + column)."""
    order = [0] * SLICE_K_BF16
    for col in range(SLICE_K_BF16):
        q, u = divmod(col, 8)
        order[16 * (u // 4) + 8 * (u // 2 % 2) + 2 * q + u % 2] = col
    return tuple(order)


BUILD_ORDER = _build_order()


def prepare_weight_bf16(w, build_order: bool):
    """W [C, C] f32 (JAX layout [in, out]) as the bf16 kernel streams it:
    W^T rounded to bf16 in `core_layout`'s order, slices of SLICE_K_BF16
    input rows.  With `build_order` (W_l1, whose A the kernel builds from
    its loads) the rows of each slice are taken in BUILD_ORDER; without it
    (W_c0, whose A is the accumulator's fragment) in their own order.
    Returns [C // SLICE_K_BF16, SLICE_K_BF16 * C] bf16."""
    wt = w.t().to(torch.bfloat16)
    if build_order:
        c = wt.shape[1]
        base = torch.arange(0, c, SLICE_K_BF16, device=w.device)[:, None]
        wt = wt[:, (base + torch.tensor(BUILD_ORDER, device=w.device)).reshape(-1)]
    return core_layout(wt, SLICE_K_BF16).contiguous()


class KernelWeights(NamedTuple):
    """A layer's weights in the form its kernel reads: `tables` T_sp's
    rows, then T_p's, [TABLE_ROWS, C] (float32 in the float32 mode, bf16 in
    the bf16 mode), `w1` / `wc` W_l1 / W_c0 prepared (wc None without the
    coord MLP)."""
    tables: torch.Tensor
    w1: torch.Tensor
    wc: torch.Tensor | None


def prepare_layer(t_sp, t_p, w_l1, w_c0=None, dtype=None) -> KernelWeights:
    """The kernel-side form of one layer's step-invariant operands (the
    arguments as `fused_edge_layer`'s), for the mode `dtype` names."""
    rounding(dtype)
    tables = torch.cat([t_sp, t_p]).float()
    if dtype is None:
        return KernelWeights(tables.contiguous(), prepare_weight(w_l1),
                             None if w_c0 is None else prepare_weight(w_c0))
    return KernelWeights(tables.to(torch.bfloat16).contiguous(),
                         prepare_weight_bf16(w_l1, True),
                         None if w_c0 is None else prepare_weight_bf16(w_c0, False))


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
    a [P, N, C] (source projection incl. the edge-MLP bias), B [P, N, C]
    (float32, or in the bf16 mode bfloat16);
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
def _lib(single: bool):
    lib = _build.load("fused_egcl")
    if single:
        fn = lib.fused_egcl_bf16_launch
        fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    else:
        fn = lib.fused_egcl_launch
        fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_edge_layer(idx, edge_mask, ebin, egeo, a, B, t_sp, t_p, w_r, w_l1, b_l1,
                     w_att, b_att, coord_params=None, dtype=None, prepared=None):
    """One E_GCL edge pipeline; arguments as `fused_edge_layer_plain` (B
    may be bfloat16 in the bf16 mode).  On CPU tensors it runs the plain
    version.  On CUDA tensors it launches the kernel of the mode `dtype`
    names (None: three bf16 passes; torch.bfloat16: one), or raises; the
    kernel reads t_sp, t_p, w_l1 and coord_params' w_c0 from `prepared`
    alone (`prepare_layer`'s form of them for that mode, required there),
    and the raw four serve the CPU's plain version only (None will do)."""
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
    dev, f32, bf16 = a.device, torch.float32, torch.bfloat16
    single = dtype is not None
    coord = coord_params is not None
    req = _build.require
    if prepared is None:
        raise ValueError("fused_edge_layer on CUDA tensors reads t_sp, t_p, w_l1 and w_c0 "
                         "from prepared=prepare_layer(t_sp, t_p, w_l1, w_c0, dtype)")
    req(idx, "idx", torch.int32, (p, n, k), dev)
    req(edge_mask, "edge_mask", f32, (p, n, k), dev)
    req(ebin, "ebin", torch.int32, (p, n, k, EBIN_WIDTH), dev)
    req(egeo, "egeo", f32, (p, n, k, EGEO_WIDTH), dev)
    req(a, "a", f32, (p, n, c), dev)
    if single and B.dtype != bf16:
        req(B, "B", f32, (p, n, c), dev)
        B = B.to(bf16)
    req(B, "B", bf16 if single else f32, (p, n, c), dev)
    for name, t, shape in (("w_r", w_r, (c,)), ("b_l1", b_l1, (c,)), ("w_att", w_att, (c,)),
                           ("b_att", b_att, (1,))):
        req(t, name, f32, shape, dev)
    req(prepared.tables, "prepared tables", bf16 if single else f32, (TABLE_ROWS, c), dev)
    if single:
        w_shape = (c // SLICE_K_BF16, SLICE_K_BF16 * c)
        tables = (_build.aligned(prepared.tables),)
    else:
        w_shape = (c // SLICE_K, 2, SLICE_K * c)
        tables = tuple(map(_build.aligned, prepared.tables.split([SPATIAL_DIM, TABLE_ROWS -
                                                                  SPATIAL_DIM])))
    req(prepared.w1, "prepared w1", bf16, w_shape, dev)
    a, B, w_r, b_l1, w_att = map(_build.aligned, (a, B, w_r, b_l1, w_att))
    agg = torch.empty((p, n, c), dtype=f32, device=dev)
    if coord:
        _, b_c0, w_c1 = coord_params
        req(prepared.wc, "prepared wc", bf16, w_shape, dev)
        req(b_c0, "b_c0", f32, (c,), dev)
        req(w_c1, "w_c1", f32, (c,), dev)
        b_c0, w_c1 = _build.aligned(b_c0), _build.aligned(w_c1)
        trans = torch.empty((p, n, 3), dtype=f32, device=dev)
        extra = (prepared.wc.data_ptr(), b_c0.data_ptr(), w_c1.data_ptr(), trans.data_ptr())
    else:
        extra = (None, None, None, None)
    sizes = (p, n, k, c) + ((TABLE_ROWS,) if single else ()) + (int(coord),)
    rc = _build.launch(
        _lib(single), dev,
        idx.data_ptr(), edge_mask.data_ptr(), ebin.data_ptr(), egeo.data_ptr(),
        a.data_ptr(), B.data_ptr(), *(t.data_ptr() for t in tables), w_r.data_ptr(),
        prepared.w1.data_ptr(), b_l1.data_ptr(), w_att.data_ptr(), b_att.data_ptr(),
        *extra[:3], agg.data_ptr(), extra[3], *sizes,
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
