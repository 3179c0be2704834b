"""Training-time complex cropping (host-side numpy; the port's own copy of
`dfmdock_tpu/data/crop.py`, kept numpy so that a `np.random.RandomState`
seed gives exactly the JAX package's crop).

Mirrors reference src/utils/crop.py:51-191 / datasets/ppi_dataset.py:333-365:
spatial crop around a random interface residue (CA-distance ordered, 1e-3
index tie-break) with a contiguous per-chain fallback.  The reference crops
inside the training step (DFMDock.py:106-110); here crops run when the
training pool is built, so every pool row has one padded shape: the crop
depends only on the ground-truth geometry, so the result is equivalent.
"""
from __future__ import annotations

import numpy as np


def interface_residue_idxs(pos, asym_id, interface_threshold=10.0, rng=None):
    """Indices of residues with any backbone atom within threshold of the
    other chain (crop.py:51-60)."""
    flat = pos.reshape(pos.shape[0], -1, 3)
    d = np.linalg.norm(
        flat[:, None, :, None, :] - flat[None, :, None, :, :], axis=-1
    ).reshape(pos.shape[0], pos.shape[0], -1).min(-1)
    diff_chain = asym_id[:, None] != asym_id[None, :]
    d = np.where(diff_chain, d, np.inf)
    return np.where((d < interface_threshold).any(-1))[0]


def spatial_crop_idxs(pos, asym_id, crop_size, rng: np.random.RandomState,
                      interface_threshold=10.0):
    """Crop to the `crop_size` residues nearest (by CA distance) to a random
    interface residue (crop.py:62-84)."""
    iface = interface_residue_idxs(pos, asym_id, interface_threshold)
    if len(iface) == 0:
        return contiguous_crop_idxs(asym_id, crop_size, rng)
    target = iface[rng.randint(0, len(iface))]
    ca = pos[:, 1, :]
    d = np.linalg.norm(ca - ca[target], axis=-1)
    d = d + np.arange(len(d)) * 1e-3  # deterministic tie-break (crop.py:76-82)
    return np.sort(np.argsort(d)[:crop_size])


def contiguous_crop_idxs(asym_id, crop_size, rng: np.random.RandomState):
    """Random contiguous segment per chain under a shared budget
    (crop.py:86-127)."""
    uniq, counts = np.unique(asym_id, return_counts=True)
    starts = {u: int(np.where(asym_id == u)[0][0]) for u in uniq}
    order = rng.permutation(len(uniq))

    budget = crop_size
    remaining = int(counts.sum())
    crops = []
    for i, oi in enumerate(order):
        chain_len = int(counts[oi])
        remaining -= chain_len
        if i == 0:
            hi = min(budget - 50, chain_len)
            lo = min(chain_len, 50)
        else:
            hi = min(budget, chain_len)
            lo = min(chain_len, max(50, budget - remaining))
        take = rng.randint(lo, max(hi, lo) + 1)
        budget -= take
        start = rng.randint(0, chain_len - take + 1)
        off = starts[uniq[oi]]
        crops.append(np.arange(off + start, off + start + take))
    return np.sort(np.concatenate(crops))


def crop_complex(rec_x, lig_x, rec_pos, lig_pos, crop_size, rng=None,
                 use_spatial=True):
    """Crop a complex to <= crop_size residues; returns cropped
    (rec_x, lig_x, rec_pos, lig_pos, res_id, asym_id) with res_id keeping the
    ORIGINAL indices (relpos uses true sequence offsets — crop.py:158-191)."""
    rng = rng or np.random.RandomState()
    n_rec, n_lig = rec_x.shape[0], lig_x.shape[0]
    n = n_rec + n_lig
    pos = np.concatenate([rec_pos, lig_pos])
    x = np.concatenate([rec_x, lig_x])
    asym_id = np.zeros(n, np.int32)
    asym_id[n_rec:] = 1
    res_id = np.arange(n, dtype=np.int32)

    if n <= crop_size:
        idxs = np.arange(n)
    elif use_spatial:
        idxs = spatial_crop_idxs(pos, asym_id, crop_size, rng)
    else:
        idxs = contiguous_crop_idxs(asym_id, crop_size, rng)

    x, pos = x[idxs], pos[idxs]
    res_id, asym_id = res_id[idxs], asym_id[idxs]
    sep = int(np.searchsorted(asym_id, 1))
    return x[:sep], x[sep:], pos[:sep], pos[sep:], res_id, asym_id
