"""Dependency-free PDB reading and writing for backbone-level docking
(mirrors `dfmdock_tpu/data/pdb_io.py`).

The reader keeps ATOM records only, residues only when the full N/CA/C
backbone is present, and the sequence from 3-letter codes (unknown -> X).
The writer emits N/CA/C(/O/CB) records with CB reconstructed from the
backbone and O placed by ideal geometry (reference utils/pdb.py,
inference_mlsb.py).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from dfmdock_tpu_torch.features.residues import restype_1to3, restype_3to1


@dataclasses.dataclass
class PDBChainData:
    seq: str
    bb_coords: np.ndarray  # [L, 3, 3] N/CA/C
    aa_coords: np.ndarray  # [A, 3] every kept (non-hetero) atom
    atom_lines: list  # (residue key, atom name, residue name, chain) per kept atom
    chain_ids: list  # chain of each kept residue


def parse_pdb(path: str, chains: list[str] | None = None) -> PDBChainData:
    """ATOM records of `path` (of `chains` only, if given), grouped into
    residues by (chain id, residue number, insertion code); the first
    altloc of each atom name wins; residues without a complete N/CA/C
    backbone are dropped."""
    residues: dict = {}
    atoms = []
    with open(path) as f:
        for line in f:
            if not line.startswith("ATOM"):
                continue
            chain_id = line[21]
            if chains is not None and chain_id not in chains:
                continue
            key = (chain_id, line[22:26].strip(), line[26])
            res_name = line[17:20].strip()
            atom_name = line[12:16].strip()
            xyz = (float(line[30:38]), float(line[38:46]), float(line[46:54]))
            rec = residues.setdefault(key, {"name": res_name, "atoms": {}})
            rec["atoms"].setdefault(atom_name, xyz)
            atoms.append((key, atom_name, xyz, res_name, chain_id))

    kept = {key: rec for key, rec in residues.items()
            if {"N", "CA", "C"}.issubset(rec["atoms"])}
    kept_atoms = [a for a in atoms if a[0] in kept]
    return PDBChainData(
        seq="".join(restype_3to1.get(rec["name"], "X") for rec in kept.values()),
        bb_coords=np.asarray(
            [[rec["atoms"][a] for a in ("N", "CA", "C")] for rec in kept.values()],
            np.float64).astype(np.float32).reshape(-1, 3, 3),
        aa_coords=np.asarray([a[2] for a in kept_atoms],
                             np.float64).astype(np.float32).reshape(-1, 3),
        atom_lines=[(key, name, res, chain) for key, name, _, res, chain in kept_atoms],
        chain_ids=[key[0] for key in kept],
    )


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
