"""Loaders of the reference's external training corpora, DIPS and PINDER
(mirrors `dfmdock_tpu/data/external.py`).  Neither corpus ships with the
repository; each loader reads the reference's on-disk format and fails
with a clear message when the data is absent.

- DIPS: reference-format `.pt` complexes (torch_geometric HeteroData; read
  by data/convert.load_pt_complex without torch_geometric) and a split list.
- PINDER: one gzip pickle per complex (receptor/ligand sequences and
  backbone coordinates), ESM2 embeddings from an HDF5 sidecar keyed by id.
Both unpickle their files: use them on data you trust.
"""
from __future__ import annotations

import gzip
import os
import pickle

import numpy as np

from dfmdock_tpu_torch.data.convert import load_pt_complex


class DIPSDataset:
    """Directory of reference-format .pt complexes and a split list; ids
    like 'ab/1abc.pdb1_0' name the file 'ab_1abc.pdb1_0.pt'."""

    def __init__(self, data_dir: str, list_file: str):
        if not os.path.isdir(data_dir):
            raise FileNotFoundError(
                f"DIPS data not found at {data_dir}. Preprocess with the "
                "reference pipeline or convert to npz via dfmdock_tpu_torch.data.convert."
            )
        self.data_dir = data_dir
        with open(list_file) as f:
            self.ids = [line.strip() for line in f if line.strip()]

    def __len__(self) -> int:
        return len(self.ids)

    def load_raw(self, idx: int) -> dict:
        _id = self.ids[idx]
        if "/" in _id:  # the DIPS id mangling
            head, tail = _id.split("/", 1)
            _id = head + "_" + tail.rsplit(".", 1)[0]
        d = load_pt_complex(os.path.join(self.data_dir, _id + ".pt"))
        d["id"] = _id
        return d


class PinderDataset:
    """PINDER gzip-pickle complexes with an optional ESM2 HDF5 sidecar."""

    def __init__(self, data_dir: str, ids: list[str] | None = None,
                 esm_h5: str | None = None):
        if not os.path.isdir(data_dir):
            raise FileNotFoundError(
                f"PINDER data not found at {data_dir}; download via pinder.core "
                "and preprocess per the reference pipeline."
            )
        self.data_dir = data_dir
        self.esm_h5 = esm_h5
        if ids is None:
            ids = sorted(f[: -len(".pkl.gz")] for f in os.listdir(data_dir)
                         if f.endswith(".pkl.gz"))
        self.ids = ids

    def __len__(self) -> int:
        return len(self.ids)

    def load_raw(self, idx: int) -> dict:
        _id = self.ids[idx]
        with gzip.open(os.path.join(self.data_dir, _id + ".pkl.gz"), "rb") as f:
            d = pickle.load(f)
        out = {
            "id": _id,
            "rec_seq": d["rec_seq"],
            "lig_seq": d["lig_seq"],
            "rec_pos": np.asarray(d["rec_pos"], np.float32),
            "lig_pos": np.asarray(d["lig_pos"], np.float32),
        }
        if self.esm_h5:
            import h5py

            with h5py.File(self.esm_h5, "r") as h5:
                out["rec_x"] = np.asarray(h5[_id]["receptor"], np.float32)
                out["lig_x"] = np.asarray(h5[_id]["ligand"], np.float32)
        elif "rec_x" in d:
            out["rec_x"] = np.asarray(d["rec_x"], np.float32)
            out["lig_x"] = np.asarray(d["lig_x"], np.float32)
        return out
