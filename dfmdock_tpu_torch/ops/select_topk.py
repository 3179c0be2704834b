"""Fused edge selection: kNN plus Gumbel-top-k in one pass per row.

Replaces the TPU kernel `dfmdock_tpu/ops/select_topk.py:select_topk_fused`
(kernel body `_kernel`, extraction `_extract_topk`).  For each row i of each
pose, with masked_neg = where(node_mask[j], -dist_ij, -1e30):

- the `knn` largest masked_neg (self included), kth = the last of them;
- then the `sample_size` largest of where(masked_neg < kth, y, -1e30) over
  the row, where y = where(node_mask[j], -3 log max(d, 1e-10), -1e30) +
  gumbel comes precomputed (models/edges.select_edges builds it);
- ties go to the lower index in both selections, so the result is fixed
  for any input (torch.topk leaves the order of ties open);
- edge_mask = node_mask[i] & slot validity & node_mask[idx], the slots of
  graphs with fewer than knn + sample_size valid nodes masked as in
  `select_edges`.

`select_topk` launches the CUDA kernel (csrc/select_topk.cu) for CUDA
tensors and runs `select_topk_plain` for CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from dfmdock_tpu_torch.ops import _build

NEG_INF = -1e30  # masked-lane value, as models/edges
MAX_N = 4096  # shared memory of a block: 4 rows of keys and node_mask, 72 KB at 4096


def slot_mask(idx, node_mask, knn: int, sample_size: int):
    """edge_mask [..., N, knn + sample_size] f32 of selected neighbours idx:
    the kNN slots 0..min(n, knn)-1 and the sample slots 0..clip(n - knn)-1
    hold edges, n = the number of valid nodes; both ends must be valid."""
    n = node_mask.sum()
    slot = torch.arange(knn + sample_size, device=idx.device)
    slot_ok = torch.where(slot < knn, slot < torch.clamp(n, max=knn),
                          (slot - knn) < torch.clamp(n - knn, 0, sample_size))
    return (node_mask[:, None] & slot_ok & node_mask[idx.long()]).to(torch.float32)


def select_topk_plain(dist, y, node_mask, knn: int = 20, sample_size: int = 40):
    """Plain PyTorch version: stable sorts fix the tie order.

    dist, y [..., N, N] f32; node_mask [N] bool -> idx [..., N, knn +
    sample_size] int32, edge_mask (same shape) f32."""
    masked_neg = torch.where(node_mask, -dist, torch.full_like(dist, NEG_INF))
    vals, order = torch.sort(masked_neg, dim=-1, descending=True, stable=True)
    parts = [order[..., :knn]]
    if sample_size > 0:
        kept = torch.where(masked_neg < vals[..., knn - 1 : knn], y,
                           torch.full_like(y, NEG_INF))
        parts.append(torch.sort(kept, dim=-1, descending=True, stable=True)[1][..., :sample_size])
    idx = torch.cat(parts, -1).to(torch.int32)
    return idx, slot_mask(idx, node_mask, knn, sample_size)


@functools.cache
def _lib():
    fn = _build.load("select_topk").select_topk_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    return fn


def select_topk(dist, y, node_mask, knn: int = 20, sample_size: int = 40):
    """The selected edges of every row; arguments as `select_topk_plain`."""
    if dist.device.type == "cpu":
        return select_topk_plain(dist, y, node_mask, knn, sample_size)
    if dist.device.type != "cuda":
        raise ValueError(f"select_topk: no kernel for device {dist.device}")
    *lead, n, _ = dist.shape
    if not (0 < knn <= n and sample_size <= n and n <= MAX_N):
        raise ValueError(f"select_topk kernel takes knn in 1..N, sample_size <= N "
                         f"and N <= {MAX_N}, got knn={knn}, sample_size={sample_size}, N={n}")
    poses = 1
    for d in lead:
        poses *= d
    dev = dist.device
    _build.require(dist, "dist", torch.float32, (*lead, n, n), dev)
    _build.require(y, "y", torch.float32, (*lead, n, n), dev)
    _build.require(node_mask, "node_mask", torch.bool, (n,), dev)
    # the kernel's float4 loads: a view that starts off 16 bytes is copied
    dist, y = _build.aligned(dist), _build.aligned(y)
    k = knn + sample_size
    idx = torch.empty((*lead, n, k), dtype=torch.int32, device=dev)
    edge_mask = torch.empty((*lead, n, k), dtype=torch.float32, device=dev)
    rc = _build.launch(
        _lib(), dev, dist.data_ptr(), y.data_ptr(), node_mask.data_ptr(), poses, n, knn,
        sample_size, idx.data_ptr(), edge_mask.data_ptr(),
    )
    _build.check(rc, "select_topk")
    select_topk.launches += 1
    return idx, edge_mask


select_topk.launches = 0
