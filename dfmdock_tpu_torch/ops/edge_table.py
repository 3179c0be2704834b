"""Per-step edge table: the features every EGCL layer reads, one pass.

Replaces the TPU kernel `dfmdock_tpu/ops/edge_table.py:build_edge_table`
(kernel body `_kernel`).  For every selected edge (i, j = idx[p, i, k]) it
gathers N/CA/virtual-CB, res_id and asym_id of both ends and computes

- the trRosetta dist/omega/theta/phi bins (angle bins zeroed at >= 22 A or
  i == j) and the AF2 relpos class (66-way);
- the EGNN geometry: squared CA distance and the (normalized) coord-diff.

Layout (free in the port; it is what `ops/fused_egcl.py` reads beside
idx and edge_mask themselves):
  ebin [P, N, K, EBIN_WIDTH] int32: dist/omega/theta/phi bin, relpos
  egeo [P, N, K, EGEO_WIDTH] f32:   radial, coord-diff x/y/z

`build_edge_table` launches the CUDA kernel (csrc/edge_table.cu) for CUDA
tensors and runs `build_edge_table_plain` for CPU tensors.  `edge_bins` is
its bins-only mode, the port of the parked TPU kernel
`dfmdock_tpu/ops/edge_bins.py:edge_bins`: ebin alone, from the same kernel
source without the geometry stores (`edge_bins_plain` on CPU tensors).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from dfmdock_tpu_torch.features.positional import relpos_bin_at
from dfmdock_tpu_torch.features.sixd import (
    ANGLE_BOUNDARIES,
    DIST_BOUNDARIES,
    PHI_BOUNDARIES,
    gather_rows,
    sixd_bins_at,
)
from dfmdock_tpu_torch.ops import _build

E_DB, E_OB, E_TB, E_PB, E_RP = range(5)
EBIN_WIDTH = 5
G_RAD, G_CD = 0, 1  # G_CD..G_CD+2 = coord-diff (i - j) x/y/z
EGEO_WIDTH = 4


def edge_bins_plain(idx, pos, res_id, asym_id):
    """Plain PyTorch version of the bins: idx [P, N, K] int32, pos
    [P, N, 3, 3] f32, res_id / asym_id [N] int32 -> ebin [P, N, K, 5] int32."""
    rp = relpos_bin_at(res_id, asym_id, idx)
    return torch.stack([*sixd_bins_at(pos, idx), rp], -1)


def edge_geometry(idx, pos, *, normalize: bool):
    """egeo [P, N, K, 4] f32: squared CA distance and the (normalized) CA
    coord-diff i - j of every edge, in plain PyTorch (the JAX package's
    `build_edge_table_xla` geometry)."""
    ca = pos[..., 1, :]
    cdiff = ca[..., :, None, :] - gather_rows(ca, idx.long())
    radial = (cdiff * cdiff).sum(-1)
    if normalize:
        cdiff = cdiff / (torch.sqrt(radial + 1e-8) + 1.0)[..., None]
    return torch.cat([radial[..., None], cdiff], -1)


def build_edge_table_plain(idx, pos, res_id, asym_id, *, normalize: bool):
    """Plain PyTorch version: the features as the eager path computes them.

    idx [P, N, K] int32, pos [P, N, 3, 3] f32, res_id / asym_id [N] int32
    -> (ebin, egeo).  Masked edges get finite values like any other."""
    return (edge_bins_plain(idx, pos, res_id, asym_id),
            edge_geometry(idx, pos, normalize=normalize))


_BOUNDS: dict = {}


def _bounds(device) -> torch.Tensor:
    """dist | angle | phi boundaries as one f32 tensor on `device`."""
    if device not in _BOUNDS:
        _BOUNDS[device] = torch.tensor(
            DIST_BOUNDARIES + ANGLE_BOUNDARIES + PHI_BOUNDARIES,
            dtype=torch.float32, device=device,
        )
    return _BOUNDS[device]


@functools.cache
def _lib(entry: str, geometry: bool):
    fn = getattr(_build.load("edge_table"), entry)
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * (4 if geometry else 3)
                   + [ctypes.c_void_p] * (3 if geometry else 2))
    fn.restype = ctypes.c_int
    return fn


def _check_inputs(idx, pos, res_id, asym_id):
    p, n, k = idx.shape
    dev = pos.device
    _build.require(idx, "idx", torch.int32, (p, n, k), dev)
    _build.require(pos, "pos", torch.float32, (p, n, 3, 3), dev)
    _build.require(res_id, "res_id", torch.int32, (n,), dev)
    _build.require(asym_id, "asym_id", torch.int32, (n,), dev)
    return p, n, k, dev


def build_edge_table(idx, pos, res_id, asym_id, *, normalize: bool):
    """The edge table of the selected edges; see the module docstring."""
    if pos.device.type == "cpu":
        return build_edge_table_plain(idx, pos, res_id, asym_id, normalize=normalize)
    if pos.device.type != "cuda":
        raise ValueError(f"build_edge_table: no kernel for device {pos.device}")
    p, n, k, dev = _check_inputs(idx, pos, res_id, asym_id)
    ebin = torch.empty((p, n, k, EBIN_WIDTH), dtype=torch.int32, device=dev)
    egeo = torch.empty((p, n, k, EGEO_WIDTH), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = _lib("edge_table_launch", True)(
            idx.data_ptr(), pos.data_ptr(), res_id.data_ptr(),
            asym_id.data_ptr(), _bounds(dev).data_ptr(), p, n, k, int(normalize),
            ebin.data_ptr(), egeo.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(rc, "edge_table")
    build_edge_table.launches += 1
    return ebin, egeo


def edge_bins(idx, pos, res_id, asym_id):
    """The bins of the selected edges alone; arguments and ebin as
    `build_edge_table`."""
    if pos.device.type == "cpu":
        return edge_bins_plain(idx, pos, res_id, asym_id)
    if pos.device.type != "cuda":
        raise ValueError(f"edge_bins: no kernel for device {pos.device}")
    p, n, k, dev = _check_inputs(idx, pos, res_id, asym_id)
    ebin = torch.empty((p, n, k, EBIN_WIDTH), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = _lib("edge_bins_launch", False)(
            idx.data_ptr(), pos.data_ptr(), res_id.data_ptr(), asym_id.data_ptr(),
            _bounds(dev).data_ptr(), p, n, k, ebin.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(rc, "edge_bins")
    edge_bins.launches += 1
    return ebin


build_edge_table.launches = 0
edge_bins.launches = 0
