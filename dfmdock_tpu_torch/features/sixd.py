"""trRosetta-style 6D pair geometry as integer bins at selected neighbours.

Bins follow `dfmdock_tpu/features/sixd.py` (reference score_net_mlsb.get_bins
and coords6d.py):
  dist:  40 bins, bin = sum(d > boundaries), boundaries over (3.25, 50.75)
  omega: 24 bins over (-180, 180) deg, dihedral (Ca_i, Cb_i, Cb_j, Ca_j)
  theta: 24 bins over (-180, 180) deg, dihedral (N_i, Ca_i, Cb_i, Cb_j)
  phi:   12 bins over (0, 180) deg, planar angle (Ca_i, Cb_i, Cb_j)
omega/theta/phi bins are zeroed where dist >= 22 A or i == j.  A NaN angle
(degenerate geometry) compares False against every boundary and lands in
bin 0, as in the reference.

All functions take leading batch dimensions: pos [..., N, 3, 3] with
idx [..., N, K].
"""
from __future__ import annotations

import functools
import math

import torch

NUM_DIST_BINS = 40
NUM_OMEGA_BINS = 24
NUM_THETA_BINS = 24
NUM_PHI_BINS = 12
SPATIAL_DIM = NUM_DIST_BINS + NUM_OMEGA_BINS + NUM_THETA_BINS + NUM_PHI_BINS
OMEGA_OFFSET = NUM_DIST_BINS
THETA_OFFSET = NUM_DIST_BINS + NUM_OMEGA_BINS
PHI_OFFSET = NUM_DIST_BINS + NUM_OMEGA_BINS + NUM_THETA_BINS

SPATIAL_MASK_CUTOFF = 22.0  # Angstrom

# Virtual C-beta coefficients (trRosetta)
CB_A, CB_B, CB_C = -0.58273431, 0.56802827, -0.54067466

# Bin boundaries: the exact float32 values of jnp.linspace(lo, hi, bins - 1)
# that the JAX package compares against (an f32 linspace rounds differently
# in every library, so the values are written out; a test pins them).
DIST_BOUNDARIES = tuple(3.25 + 1.25 * i for i in range(39))
ANGLE_BOUNDARIES = (
    -180.0, -163.63636779785156, -147.27272033691406, -130.90908813476562,
    -114.54544830322266, -98.18182373046875, -81.81817626953125,
    -65.45454406738281, -49.090911865234375, -32.727272033691406,
    -16.363628387451172, -1.9073486328125e-06, 16.36363983154297,
    32.727272033691406, 49.09090805053711, 65.45454406738281,
    81.81818389892578, 98.18182373046875, 114.54545593261719,
    130.90908813476562, 147.27273559570312, 163.63636779785156, 180.0,
)
PHI_BOUNDARIES = tuple(18.0 * i for i in range(11))

_DEG = 180.0 / math.pi


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [..., N, F], idx [..., N, K] -> [..., N, K, F]: x[..., idx[i, k], :]."""
    *lead, n, f = x.shape
    k = idx.shape[-1]
    flat = idx.reshape(*lead, n * k, 1).expand(*lead, n * k, f)
    return x.gather(-2, flat).reshape(*lead, n, k, f)


def virtual_cb(pos: torch.Tensor) -> torch.Tensor:
    """C-beta from backbone N/CA/C. pos: [..., 3, 3] -> [..., 3]."""
    n, ca, c = pos[..., 0, :], pos[..., 1, :], pos[..., 2, :]
    b = ca - n
    c_ = c - ca
    a = torch.linalg.cross(b, c_, dim=-1)
    return CB_A * a + CB_B * b + CB_C * c_ + ca


def pairwise_ca_dist(pos: torch.Tensor) -> torch.Tensor:
    """[..., N, 3, 3] -> [..., N, N] CA-CA distances."""
    ca = pos[..., 1, :]
    diff = ca[..., :, None, :] - ca[..., None, :, :]
    return torch.sqrt(torch.clamp((diff * diff).sum(-1), min=1e-12))


@functools.cache
def _boundaries(boundaries: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A boundary tuple as a tensor on `device`, made once: a captured step
    cannot copy from the host."""
    return torch.tensor(boundaries, dtype=dtype, device=device)


def bin_index(x: torch.Tensor, boundaries) -> torch.Tensor:
    """sum(x > boundaries) as int32 (NaN -> 0)."""
    b = _boundaries(tuple(boundaries), x.dtype, x.device)
    return (x[..., None] > b).sum(-1).to(torch.int32)


def _norm(v):
    return torch.sqrt((v * v).sum(-1, keepdim=True))


def _dihedral_deg(a, b, c, d):
    """Dihedral angle in degrees for points [..., 3] (coords6d.py)."""
    b1 = a - b
    b2 = b - c
    b3 = c - d
    n1 = torch.linalg.cross(b1, b2, dim=-1)
    n1 = n1 / _norm(n1)
    n2 = torch.linalg.cross(b2, b3, dim=-1)
    n2 = n2 / _norm(n2)
    m1 = torch.linalg.cross(n1, b2 / _norm(b2), dim=-1)
    x = (n1 * n2).sum(-1)
    y = (m1 * n2).sum(-1)
    return torch.atan2(y, x) * _DEG


def _planar_deg(a, b, c):
    """Planar angle at b in degrees (coords6d.py)."""
    v1 = a - b
    v2 = c - b
    cos = (v1 * v2).sum(-1) / (_norm(v1)[..., 0] * _norm(v2)[..., 0])
    return torch.arccos(cos) * _DEG


def sixd_values_at(pos: torch.Tensor, idx: torch.Tensor):
    """Unbinned geometry at neighbour pairs (i, idx[..., i, k]): dist (A),
    omega, theta, phi (degrees), each [..., N, K], and ca_j [..., N, K, 3]."""
    n_at = pos[..., 0, :]
    ca = pos[..., 1, :]
    cb = virtual_cb(pos)
    cacb_j = gather_rows(torch.cat([ca, cb], -1), idx.long())
    ca_j, cb_j = cacb_j[..., :3], cacb_j[..., 3:]
    ca_i = ca[..., :, None, :]
    cb_i = cb[..., :, None, :]
    n_i = n_at[..., :, None, :]
    dist = torch.sqrt(torch.clamp(((ca_i - ca_j) ** 2).sum(-1), min=1e-12))
    omega = _dihedral_deg(ca_i, cb_i, cb_j, ca_j)
    theta = _dihedral_deg(n_i, ca_i, cb_i, cb_j)
    phi = _planar_deg(ca_i, cb_i, cb_j)
    return dist, omega, theta, phi, ca_j


def sixd_bins_at(pos: torch.Tensor, idx: torch.Tensor):
    """6D bins at neighbour pairs (i, idx[..., i, k]).

    Returns (dist_bin, omega_bin, theta_bin, phi_bin), each [..., N, K] int32."""
    dist, omega, theta, phi, _ = sixd_values_at(pos, idx)
    rows = torch.arange(pos.shape[-3], device=idx.device, dtype=idx.dtype)
    keep = (dist < SPATIAL_MASK_CUTOFF) & (idx != rows[:, None])
    zero = torch.zeros((), dtype=torch.int32, device=idx.device)
    db = bin_index(dist, DIST_BOUNDARIES)
    ob = torch.where(keep, bin_index(omega, ANGLE_BOUNDARIES), zero)
    tb = torch.where(keep, bin_index(theta, ANGLE_BOUNDARIES), zero)
    pb = torch.where(keep, bin_index(phi, PHI_BOUNDARIES), zero)
    return db, ob, tb, pb


def sixd_bins_dense(pos: torch.Tensor):
    """sixd_bins_at over every pair: pos [N, 3, 3] -> four [N, N] int32 bins."""
    n = pos.shape[-3]
    idx = torch.arange(n, dtype=torch.int32, device=pos.device).expand(n, n)
    return sixd_bins_at(pos, idx)


class _TableRows(torch.autograd.Function):
    """w[idx_0] + w[idx_1] + ... (left to right), with the gradient of w as
    one GEMM, counts @ grad, counts[v, m] = #{i: idx_i[m] == v}: it sums in
    a fixed order, where the indexed form's backward is a sorted scatter
    that adds the rows of one table row in any order
    (scripts/torch_table_backward.py times both)."""

    @staticmethod
    def forward(ctx, w, *idx):
        idx = [i.long() for i in idx]
        out = w[idx[0]]
        for i in idx[1:]:
            out = out + w[i]
        ctx.save_for_backward(*idx)
        ctx.rows = w.shape[0]
        return out

    @staticmethod
    def backward(ctx, grad):
        g = grad.reshape(-1, grad.shape[-1])
        rows = torch.arange(ctx.rows, device=grad.device)[:, None]
        counts = sum((i.reshape(1, -1) == rows).to(g.dtype) for i in ctx.saved_tensors)
        return (counts @ g,) + (None,) * len(ctx.saved_tensors)


def table_rows(w: torch.Tensor, *idx: torch.Tensor) -> torch.Tensor:
    """sum_i w[idx_i]: w [V, E], each idx [...] integer -> [..., E].  The
    values are the indexed form's bit for bit; its gradient comes from the
    [V, M] x [M, E] product of the index counts (_TableRows)."""
    return _TableRows.apply(w, *idx)


def spatial_embed_from_bins(w_spatial, dist_bin, omega_bin, theta_bin, phi_bin):
    """one_hot([dist|omega|theta|phi]) @ w_spatial as four row lookups.
    w_spatial: [SPATIAL_DIM, edge_dim]."""
    return table_rows(w_spatial, dist_bin, OMEGA_OFFSET + omega_bin,
                      THETA_OFFSET + theta_bin, PHI_OFFSET + phi_bin)
