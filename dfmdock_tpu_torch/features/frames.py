"""Residue rigid frames and frame-relative pair features (mirrors
`dfmdock_tpu/features/frames.py`; reference src/utils/frame.py): frames by
Gram-Schmidt from N/CA/C, and the 25-wide pair features
[distance RBF (16) | direction in frame i (3) | relative orientation 6D (6)]."""
from __future__ import annotations

import torch

from dfmdock_tpu_torch.geom.rotations import matrix_to_rotation_6d


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.linalg.norm(v, dim=-1, keepdim=True).clamp(min=1e-12)


def residue_frames(pos: torch.Tensor) -> torch.Tensor:
    """[N, 3, 3] backbone -> [N, 3, 3] rotations with columns e1, e2, e3:
    e1 = unit(C - CA), e2 = unit(N - CA orthogonalised against e1),
    e3 = e1 x e2."""
    n_at, ca, c_at = pos[:, 0], pos[:, 1], pos[:, 2]
    e1 = _unit(c_at - ca)
    v2 = n_at - ca
    e2 = _unit(v2 - e1 * (e1 * v2).sum(-1, keepdim=True))
    e3 = torch.linalg.cross(e1, e2, dim=-1)
    return torch.stack([e1, e2, e3], dim=-1)


def rbf(values: torch.Tensor, v_min: float = 2.0, v_max: float = 22.0,
        n_bins: int = 16) -> torch.Tensor:
    """Radial basis encoding [...] -> [..., n_bins]."""
    centers = torch.linspace(v_min, v_max, n_bins, dtype=values.dtype, device=values.device)
    std = (v_max - v_min) / n_bins
    z = (values[..., None] - centers) / std
    return torch.exp(-(z**2))


def pair_features(trans: torch.Tensor, rotat: torch.Tensor) -> torch.Tensor:
    """[N, 3] CA and [N, 3, 3] frames -> [N, N, 25] pair features."""
    vec = trans[:, None, :] - trans[None, :, :]
    dist = torch.linalg.norm(vec, dim=-1)
    direct = vec / dist[..., None].clamp(min=1e-12)
    direct = torch.einsum("ikc,ijk->ijc", rotat, direct)  # R_i^T v_ij
    orient = torch.einsum("iab,jac->ijbc", rotat, rotat)  # R_i^T R_j
    return torch.cat([rbf(dist), direct, matrix_to_rotation_6d(orient)], dim=-1)
