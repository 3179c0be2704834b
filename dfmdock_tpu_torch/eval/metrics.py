"""CAPRI/DockQ docking metrics on backbone tensors (host-side numpy, f64).

Same protocol as reference src/utils/metrics.py:
  c_rmsd: complex backbone RMSD after Kabsch alignment of the full complex
  i_rmsd: interface backbone RMSD (native interface residues @ 10 A min
          inter-atom distance), Kabsch-aligned on the interface
  l_rmsd: ligand RMSD after aligning on the receptor
  fnat:   fraction of native residue contacts (@ 5.5 A) recovered
  DockQ = (fnat + 1/(1+(iRMSD/1.5)^2) + 1/(1+(lRMSD/8.5)^2)) / 3
"""
from __future__ import annotations

import numpy as np


def _kabsch(A: np.ndarray, B: np.ndarray):
    """Align A onto B; returns (R, t) with det(R)=+1 (metrics.py:87-121)."""
    a_mean = A.mean(0)
    b_mean = B.mean(0)
    H = (A - a_mean).T @ (B - b_mean)
    U, _, Vt = np.linalg.svd(H)
    R = Vt.T @ U.T
    if np.linalg.det(R) < 0:
        R = (Vt.T @ np.diag([1.0, 1.0, -1.0])) @ U.T
    t = b_mean - R @ a_mean
    return R, t


def _rmsd(a, b):
    return float(np.sqrt(((a - b) ** 2).sum(-1).mean()))


def _min_residue_dist(x1, x2):
    """[R,3,3] x [L,3,3] -> [R,L] min distance over the 3x3 atom pairs."""
    d = x1[:, None, :, None, :] - x2[None, :, None, :, :]
    d = np.sqrt((d**2).sum(-1)).reshape(x1.shape[0], x2.shape[0], -1)
    return d.min(-1)


def interface_residues(rec, lig, cutoff=10.0):
    m = _min_residue_dist(rec, lig) < cutoff
    return np.where(m.any(1))[0], np.where(m.any(0))[0]


def c_rmsd(model_rec, model_lig, native_rec, native_lig):
    pred = np.concatenate([model_rec, model_lig]).reshape(-1, 3)
    label = np.concatenate([native_rec, native_lig]).reshape(-1, 3)
    R, t = _kabsch(pred, label)
    return _rmsd(pred @ R.T + t, label)


def i_rmsd(model_rec, model_lig, native_rec, native_lig, cutoff=10.0):
    r1, r2 = interface_residues(native_rec, native_lig, cutoff)
    pred = np.concatenate([model_rec[r1], model_lig[r2]]).reshape(-1, 3)
    label = np.concatenate([native_rec[r1], native_lig[r2]]).reshape(-1, 3)
    R, t = _kabsch(pred, label)
    return _rmsd(pred @ R.T + t, label)


def l_rmsd(model_rec, model_lig, native_rec, native_lig):
    R, t = _kabsch(model_rec.reshape(-1, 3), native_rec.reshape(-1, 3))
    return _rmsd(model_lig.reshape(-1, 3) @ R.T + t, native_lig.reshape(-1, 3))


def fnat(model_rec, model_lig, native_rec, native_lig, cutoff=5.5):
    native_d = _min_residue_dist(native_rec, native_lig)
    ai, aj = np.where(native_d < cutoff)
    pred_d = _min_residue_dist(model_rec, model_lig)
    count = int((pred_d[ai, aj] < cutoff).sum())
    return round(count / (len(ai) + 1e-6), 6)


def dockq(i_rmsd_val, l_rmsd_val, fnat_val):
    return (
        fnat_val
        + 1.0 / (1.0 + (i_rmsd_val / 1.5) ** 2)
        + 1.0 / (1.0 + (l_rmsd_val / 8.5) ** 2)
    ) / 3.0


def compute_metrics(model, native):
    """model/native: (rec [R,3,3], lig [L,3,3]) numpy arrays.
    Returns dict with c_rmsd, i_rmsd, l_rmsd, fnat, DockQ (metrics.py:3-16)."""
    mr, ml = np.asarray(model[0], np.float64), np.asarray(model[1], np.float64)
    nr, nl = np.asarray(native[0], np.float64), np.asarray(native[1], np.float64)
    c = c_rmsd(mr, ml, nr, nl)
    i = i_rmsd(mr, ml, nr, nl)
    l = l_rmsd(mr, ml, nr, nl)
    f = fnat(mr, ml, nr, nl)
    return {"c_rmsd": c, "i_rmsd": i, "l_rmsd": l, "fnat": f, "DockQ": dockq(i, l, f)}
