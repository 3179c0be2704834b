"""Rotation parameterizations (mirrors `dfmdock_tpu/geom/rotations.py`).

Quaternions are (w, x, y, z) with the real part first; axis-angle vectors
have magnitude = rotation angle in radians.  Every conversion is branch-free
and batched over leading dimensions.
"""
from __future__ import annotations

import torch

_EPS = 1e-12


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((v * v).sum(-1, keepdim=True))


def quaternion_to_matrix(quat: torch.Tensor) -> torch.Tensor:
    """[..., 4] (w,x,y,z) -> [..., 3, 3] rotation matrices."""
    quat = quat / _norm(quat)
    w, x, y, z = quat.unbind(-1)
    o = torch.stack(
        [
            1 - 2 * (y * y + z * z),
            2 * (x * y - z * w),
            2 * (x * z + y * w),
            2 * (x * y + z * w),
            1 - 2 * (x * x + z * z),
            2 * (y * z - x * w),
            2 * (x * z - y * w),
            2 * (y * z + x * w),
            1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return o.reshape(quat.shape[:-1] + (3, 3))


def matrix_to_quaternion(matrix: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 4] (w,x,y,z): the stable candidate of four (the
    one with the largest pivot), canonical sign w >= 0."""
    m = matrix
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    q0 = torch.stack([1 + tr, m21 - m12, m02 - m20, m10 - m01], -1)
    q1 = torch.stack([m21 - m12, 1 + m00 - m11 - m22, m01 + m10, m02 + m20], -1)
    q2 = torch.stack([m02 - m20, m01 + m10, 1 - m00 + m11 - m22, m12 + m21], -1)
    q3 = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1 - m00 - m11 + m22], -1)
    cands = torch.stack([q0, q1, q2, q3], dim=-2)  # [..., 4, 4]
    cands = cands / _norm(cands).clamp(min=_EPS)
    scores = torch.stack(
        [tr, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11], dim=-1
    )
    idx = scores.argmax(-1)
    quat = torch.take_along_dim(cands, idx[..., None, None], dim=-2).squeeze(-2)
    return quat * torch.where(quat[..., :1] < 0, -1.0, 1.0)


def axis_angle_to_quaternion(axis_angle: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 4]; Taylor-safe near zero angle."""
    angle = _norm(axis_angle)
    half = 0.5 * angle
    small = angle < 1e-6
    sin_half_over_angle = torch.where(
        small,
        0.5 - (angle * angle) / 48.0,
        torch.sin(half) / torch.where(small, torch.ones_like(angle), angle),
    )
    return torch.cat([torch.cos(half), axis_angle * sin_half_over_angle], dim=-1)


def quaternion_to_axis_angle(quat: torch.Tensor) -> torch.Tensor:
    """[..., 4] (w,x,y,z) -> [..., 3]."""
    quat = quat * torch.where(quat[..., :1] < 0, -1.0, 1.0)
    norms = _norm(quat[..., 1:])
    half = torch.atan2(norms, quat[..., :1])
    angle = 2.0 * half
    small = angle.abs() < 1e-6
    scale = torch.where(
        small,
        2.0 + (angle * angle) / 12.0,
        angle / torch.where(small, torch.ones_like(half), torch.sin(half)),
    )
    return quat[..., 1:] * scale


def axis_angle_to_matrix(axis_angle: torch.Tensor) -> torch.Tensor:
    return quaternion_to_matrix(axis_angle_to_quaternion(axis_angle))


def matrix_to_axis_angle(matrix: torch.Tensor) -> torch.Tensor:
    return quaternion_to_axis_angle(matrix_to_quaternion(matrix))


def compose_axis_angle(r1: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    """Axis-angle of R2 @ R1."""
    return matrix_to_axis_angle(axis_angle_to_matrix(r2) @ axis_angle_to_matrix(r1))


def random_rotation_matrix(
    generator: torch.Generator, shape: tuple = (), device=None
) -> torch.Tensor:
    """Uniform random rotations (Haar measure) from normalized Gaussian quaternions."""
    quat = torch.randn(shape + (4,), generator=generator, device=device)
    return quaternion_to_matrix(quat)


# 6D rotation representation (Zhou et al. 2019)


def matrix_to_rotation_6d(matrix: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 6]: the first two rows of the matrix, flattened."""
    return matrix[..., :2, :].reshape(matrix.shape[:-2] + (6,))


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """[..., 6] -> [..., 3, 3] by Gram-Schmidt."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / _norm(a1).clamp(min=_EPS)
    a2p = a2 - (b1 * a2).sum(-1, keepdim=True) * b1
    b2 = a2p / _norm(a2p).clamp(min=_EPS)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


def kabsch(A: torch.Tensor, B: torch.Tensor, weights: torch.Tensor | None = None):
    """Optimal rotation R and translation t aligning A onto B: R @ A.T + t ~= B.

    A, B: [N, 3] paired point clouds; weights: optional [N] non-negative
    weights (for masked or padded input).  Returns (R [3, 3], t [3]) with
    det(R) = +1 (a reflection is corrected without a branch)."""
    if weights is None:
        a_mean, b_mean = A.mean(0), B.mean(0)
        H = (A - a_mean).T @ (B - b_mean)
    else:
        w = weights[:, None] / weights.sum().clamp(min=_EPS)
        a_mean, b_mean = (A * w).sum(0), (B * w).sum(0)
        H = ((A - a_mean) * w).T @ (B - b_mean)
    U, _, Vt = torch.linalg.svd(H)
    d = torch.sign(torch.linalg.det(Vt.T @ U.T))
    S = torch.diag(torch.stack([torch.ones_like(d), torch.ones_like(d), d]))
    R = Vt.T @ S @ U.T
    return R, b_mean - R @ a_mean


def skew(v: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] skew-symmetric cross-product matrices."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack([torch.stack([zero, -z, y], -1),
                        torch.stack([z, zero, -x], -1),
                        torch.stack([-y, x, zero], -1)], -2)
