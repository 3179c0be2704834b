"""npz complex -> padded model batch (mirrors `dfmdock_tpu/data/dataset.py`).

Node features are [ESM2 1280 | one-hot 21]; res_id/asym_id run over the
concatenated complex; nothing is cropped at inference.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from dfmdock_tpu_torch.data.batching import pad_complex
from dfmdock_tpu_torch.data.convert import load_npz_complex
from dfmdock_tpu_torch.features.residues import sequence_to_onehot


def complex_to_batch(d: dict, pad_to: int | None = None, use_esm: bool = True):
    """d: dict with rec_x/rec_pos/rec_seq/lig_* -> padded batch dict (numpy)."""
    rec_oh = sequence_to_onehot(d["rec_seq"])
    lig_oh = sequence_to_onehot(d["lig_seq"])
    if use_esm:
        rec_x = np.concatenate([d["rec_x"], rec_oh], axis=-1)
        lig_x = np.concatenate([d["lig_x"], lig_oh], axis=-1)
    else:
        rec_x, lig_x = rec_oh, lig_oh
    b = pad_complex(rec_x, lig_x, d["rec_pos"], d["lig_pos"], pad_to=pad_to)
    b["is_homomer"] = np.float32(d["rec_seq"] == d["lig_seq"])
    return b


def batch_to_tensors(batch: dict, device) -> dict:
    """The model-facing tensors of a numpy batch, on `device`."""
    out = {}
    for k in ("x", "pos", "node_mask", "lig_mask", "res_id", "asym_id"):
        out[k] = torch.from_numpy(np.asarray(batch[k])).to(device)
    return out


class NPZDataset:
    """Complex-per-file npz dataset with an id list: `test.txt` in the
    directory if present (ids without a file are dropped), else every npz
    in name order (the DB5 layout of `data/db5_npz/`).  Indexing gives a
    complex's padded numpy batch, its node features [ESM2 | one-hot], or
    the one-hot alone with use_esm=False."""

    def __init__(self, data_dir: str, list_file: str | None = None, use_esm: bool = True):
        self.data_dir = data_dir
        self.use_esm = use_esm
        if list_file is None:
            list_file = os.path.join(data_dir, "test.txt")
        if os.path.exists(list_file):
            with open(list_file) as f:
                ids = [line.strip() for line in f if line.strip()]
            self.ids = [i for i in ids
                        if os.path.exists(os.path.join(data_dir, i + ".npz"))]
        else:
            self.ids = sorted(f[:-4] for f in os.listdir(data_dir) if f.endswith(".npz"))

    def __len__(self) -> int:
        return len(self.ids)

    def load_raw(self, idx: int) -> dict:
        d = load_npz_complex(os.path.join(self.data_dir, self.ids[idx] + ".npz"))
        d["id"] = self.ids[idx]
        return d

    def __getitem__(self, idx: int) -> dict:
        d = self.load_raw(idx)
        batch = complex_to_batch(d, use_esm=self.use_esm)
        batch["id"] = d["id"]
        batch["rec_seq"] = d["rec_seq"]
        batch["lig_seq"] = d["lig_seq"]
        return batch
