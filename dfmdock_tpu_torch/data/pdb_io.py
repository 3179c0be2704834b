"""PDB writing for docked poses and trajectories (the writer half of
`dfmdock_tpu/data/pdb_io.py`).

N/CA/C(/O/CB) records with CB reconstructed from the backbone and O placed
by ideal geometry (reference utils/pdb.py, inference_mlsb.py).
"""
from __future__ import annotations

import math

import numpy as np

from dfmdock_tpu_torch.features.residues import restype_1to3


def place_fourth_atom(a, b, c, length, planar, dihedral):
    """Ideal-geometry placement of a 4th atom. numpy [..., 3]."""
    bc = b - c
    bc = bc / np.linalg.norm(bc, axis=-1, keepdims=True)
    n = np.cross(b - a, bc)
    n = n / np.linalg.norm(n, axis=-1, keepdims=True)
    m1, m2, m3 = bc, np.cross(n, bc), n
    d1 = length * math.cos(planar)
    d2 = length * math.sin(planar) * math.cos(dihedral)
    d3 = -length * math.sin(planar) * math.sin(dihedral)
    return c + m1 * d1 + m2 * d2 + m3 * d3


def get_full_coords(bb_coords: np.ndarray) -> np.ndarray:
    """[L, 3, 3] N/CA/C -> [L, 5, 3] N/CA/C/O/CB."""
    N, CA, C = bb_coords[:, 0], bb_coords[:, 1], bb_coords[:, 2]
    b = CA - N
    c = C - CA
    a = np.cross(b, c)
    CB = -0.58273431 * a + 0.56802827 * b - 0.54067466 * c + CA
    O = place_fourth_atom(np.roll(N, -1, 0), CA, C, 1.231, 2.108, -3.142)
    return np.stack([N, CA, C, O, CB], axis=1)


def save_pdb(
    out_pdb: str,
    coords: np.ndarray,
    seq: str,
    b_factors: np.ndarray | None = None,
    delim: int | None = None,
    append: bool = False,
):
    """Write [L, A, 3] coords (A=3 N/CA/C or A=5 N/CA/C/O/CB) as a two-chain
    PDB; residues up to `delim` (inclusive) get chain A, the rest chain B."""
    if delim is None:
        delim = -1
    atoms = ["N", "CA", "C", "O", "CB"][: coords.shape[1]]
    if b_factors is None:
        b_factors = np.zeros(coords.shape[0])
    with open(out_pdb, "a" if append else "w") as f:
        k = 0
        for r in range(coords.shape[0]):
            aa3 = restype_1to3.get(seq[r], "UNK")
            for a, atom in enumerate(atoms):
                if aa3 == "GLY" and atom == "CB":
                    continue
                x, y, z = coords[r, a]
                f.write(
                    "ATOM  %5d  %-3s %3s %s%4d    %8.3f%8.3f%8.3f  %4.2f %5.2f\n"
                    % (k + 1, atom, aa3, "A" if r <= delim else "B", r + 1,
                       x, y, z, 1.0, b_factors[r])
                )
                k += 1


def save_trajectory(out_pdb: str, traj_rec, traj_lig, rec_seq: str, lig_seq: str):
    """Multi-MODEL trajectory PDB: one MODEL per frame of [R, 3, 3] receptor
    and [L, 3, 3] ligand backbones (inference_mlsb.py:130-159)."""
    with open(out_pdb, "w"):
        pass
    for i, (rec, lig) in enumerate(zip(traj_rec, traj_lig)):
        coords = np.concatenate([np.asarray(rec), np.asarray(lig)], axis=0)
        with open(out_pdb, "a") as f:
            f.write(f"MODEL        {i}\n")
        save_pdb(out_pdb, get_full_coords(coords), rec_seq + lig_seq,
                 delim=len(rec_seq) - 1, append=True)
        with open(out_pdb, "a") as f:
            f.write("ENDMDL\n")
