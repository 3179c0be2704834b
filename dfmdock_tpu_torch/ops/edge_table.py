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
`bin_values` reaches the kernel's bin code alone, for tests.

On a CUDA tensor each wrapper checks its arguments, allocates its outputs
and calls the launcher with the raw handle of the current stream; the
device is switched only when the tensors lie on a device other than the
current one.  The outputs are two allocations: one split into two views took
longer on the host (scripts/torch_edge_table_breakdown.py).
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
    bin_index,
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


_P, _I = ctypes.c_void_p, ctypes.c_int
# each launcher's arguments: pointers, ints, the outputs and the stream
_ARGTYPES = {
    "edge_table_launch": [_P] * 4 + [_I] * 4 + [_P] * 3,
    "edge_bins_launch": [_P] * 4 + [_I] * 3 + [_P] * 2,
    "edge_bin_values_launch": [_P] + [_I] * 2 + [_P] * 2,
}


@functools.cache
def _lib(entry: str):
    fn = getattr(_build.load("edge_table"), entry)
    fn.argtypes = _ARGTYPES[entry]
    fn.restype = ctypes.c_int
    return fn


def _check_inputs(idx, pos, res_id, asym_id, dev):
    """(p, n, k) once every argument's device, dtype, shape and contiguity
    are what the kernel takes."""
    p, n, k = idx.shape
    _build.require(idx, "idx", torch.int32, (p, n, k), dev)
    _build.require(pos, "pos", torch.float32, (p, n, 3, 3), dev)
    _build.require(res_id, "res_id", torch.int32, (n,), dev)
    _build.require(asym_id, "asym_id", torch.int32, (n,), dev)
    return p, n, k


def build_edge_table(idx, pos, res_id, asym_id, *, normalize: bool):
    """The edge table of the selected edges; see the module docstring."""
    dev = pos.device
    if dev.type == "cpu":
        return build_edge_table_plain(idx, pos, res_id, asym_id, normalize=normalize)
    if dev.type != "cuda":
        raise ValueError(f"build_edge_table: no kernel for device {dev}")
    p, n, k = _check_inputs(idx, pos, res_id, asym_id, dev)
    ebin = torch.empty(p, n, k, EBIN_WIDTH, dtype=torch.int32, device=dev)
    egeo = torch.empty(p, n, k, EGEO_WIDTH, dtype=torch.float32, device=dev)
    rc = _build.launch(_lib("edge_table_launch"), dev, idx.data_ptr(), pos.data_ptr(),
                       res_id.data_ptr(), asym_id.data_ptr(), p, n, k, int(normalize),
                       ebin.data_ptr(), egeo.data_ptr())
    _build.check(rc, "edge_table")
    build_edge_table.launches += 1
    return ebin, egeo


def edge_bins(idx, pos, res_id, asym_id):
    """The bins of the selected edges alone; arguments and ebin as
    `build_edge_table`."""
    dev = pos.device
    if dev.type == "cpu":
        return edge_bins_plain(idx, pos, res_id, asym_id)
    if dev.type != "cuda":
        raise ValueError(f"edge_bins: no kernel for device {dev}")
    p, n, k = _check_inputs(idx, pos, res_id, asym_id, dev)
    ebin = torch.empty(p, n, k, EBIN_WIDTH, dtype=torch.int32, device=dev)
    rc = _build.launch(_lib("edge_bins_launch"), dev, idx.data_ptr(), pos.data_ptr(),
                       res_id.data_ptr(), asym_id.data_ptr(), p, n, k, ebin.data_ptr())
    _build.check(rc, "edge_bins")
    edge_bins.launches += 1
    return ebin


BIN_FAMILIES = (DIST_BOUNDARIES, ANGLE_BOUNDARIES, PHI_BOUNDARIES)


def bin_values(x, family: int):
    """The bins of float32 values x in one family (0 dist, 1 angle, 2 phi),
    by the edge kernel's bin code on a CUDA tensor (a test entry of
    csrc/edge_table.cu) and by `bin_index` on a CPU tensor: count(x > b)
    over the family's boundaries b, NaN -> 0."""
    if family not in (0, 1, 2):
        raise ValueError(f"bin_values: family {family} is not 0, 1 or 2")
    dev = x.device
    if dev.type == "cpu":
        return bin_index(x, BIN_FAMILIES[family])
    if dev.type != "cuda":
        raise ValueError(f"bin_values: no kernel for device {dev}")
    _build.require(x, "x", torch.float32, tuple(x.shape), dev)
    out = torch.empty(x.shape, dtype=torch.int32, device=dev)
    rc = _build.launch(_lib("edge_bin_values_launch"), dev, x.data_ptr(), x.numel(), family,
                       out.data_ptr())
    _build.check(rc, "edge_bin_values")
    bin_values.launches += 1
    return out


build_edge_table.launches = 0
edge_bins.launches = 0
bin_values.launches = 0
