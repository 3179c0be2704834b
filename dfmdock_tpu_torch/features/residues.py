"""Amino-acid alphabet and one-hot sequence encoding (host-side numpy), as in
`dfmdock_tpu/features/residues.py` (AlphaFold residue order; reference
src/utils/residue_constants.py)."""
from __future__ import annotations

import numpy as np

restypes = [
    "A", "R", "N", "D", "C", "Q", "E", "G", "H", "I",
    "L", "K", "M", "F", "P", "S", "T", "W", "Y", "V",
]
restype_order_with_x = {r: i for i, r in enumerate(restypes + ["X"])}

restype_1to3 = {
    "A": "ALA", "R": "ARG", "N": "ASN", "D": "ASP", "C": "CYS",
    "Q": "GLN", "E": "GLU", "G": "GLY", "H": "HIS", "I": "ILE",
    "L": "LEU", "K": "LYS", "M": "MET", "F": "PHE", "P": "PRO",
    "S": "SER", "T": "THR", "W": "TRP", "Y": "TYR", "V": "VAL",
    "X": "UNK",
}
restype_3to1 = {v: k for k, v in restype_1to3.items() if k != "X"}


def sequence_to_onehot(sequence: str) -> np.ndarray:
    """[L] one-letter sequence -> [L, 21] float32 one-hot; letters outside
    the 20 standard residues map to X, anything but an upper-case letter
    is an error."""
    out = np.zeros((len(sequence), len(restype_order_with_x)), dtype=np.float32)
    for i, aa in enumerate(sequence):
        if not (aa.isalpha() and aa.isupper()):
            raise ValueError(f"Invalid character in the sequence: {aa!r}")
        out[i, restype_order_with_x.get(aa, restype_order_with_x["X"])] = 1.0
    return out
