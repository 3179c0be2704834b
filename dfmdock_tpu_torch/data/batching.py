"""Padded batch construction (host-side numpy).

Receptor rows come first, then ligand rows, then padding, so every complex of
a bucket has one static shape.  Mirrors `dfmdock_tpu/data/batching.py`.
"""
from __future__ import annotations

import numpy as np

ENERGY_ROW_CHUNK = 64  # padded N is a multiple of this (energy-head row chunk)


def round_up(n: int, multiple: int = ENERGY_ROW_CHUNK) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def pad_complex(
    rec_x: np.ndarray,
    lig_x: np.ndarray,
    rec_pos: np.ndarray,
    lig_pos: np.ndarray,
    pad_to: int | None = None,
    res_id: np.ndarray | None = None,
    asym_id: np.ndarray | None = None,
):
    """Static-shape batch dict: x [N,F], pos [N,3,3], node_mask [N] bool,
    lig_mask [N] f32 (valid ligand rows), res_id/asym_id [N] int32, n_rec,
    n_lig.  pad_to defaults to R+L rounded up to the energy chunk.  res_id
    runs over the concatenated complex unless the original (cropped) ids
    are given; asym_id is 0 on receptor rows and 1 after, unless given."""
    R, L = rec_x.shape[0], lig_x.shape[0]
    n = R + L
    n_pad = round_up(n) if pad_to is None else pad_to
    if n_pad < n:
        raise ValueError(f"pad_to={n_pad} < complex size {n}")
    f = rec_x.shape[1]

    x = np.zeros((n_pad, f), np.float32)
    x[:R] = rec_x
    x[R : R + L] = lig_x

    pos = np.zeros((n_pad, 3, 3), np.float32)
    pos[:R] = rec_pos
    pos[R : R + L] = lig_pos

    node_mask = np.zeros(n_pad, bool)
    node_mask[:n] = True

    lig_mask = np.zeros(n_pad, np.float32)
    lig_mask[R : R + L] = 1.0

    # res_id over the concatenated complex; asym_id 0 = receptor, 1 = ligand
    rid = np.arange(n_pad, dtype=np.int32)
    if res_id is not None:
        rid[:n] = res_id
    aid = np.zeros(n_pad, np.int32)
    aid[R:] = 1
    if asym_id is not None:
        aid[:n] = asym_id

    return {
        "x": x,
        "pos": pos,
        "node_mask": node_mask,
        "lig_mask": lig_mask,
        "res_id": rid,
        "asym_id": aid,
        "n_rec": np.int32(R),
        "n_lig": np.int32(L),
    }
