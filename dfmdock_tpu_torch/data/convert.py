"""Read one preprocessed complex npz (schema of `dfmdock_tpu/data/convert.py`).

  rec_x [R,1280] f32, rec_pos [R,3,3] f32, rec_seq str
  lig_x [L,1280] f32, lig_pos [L,3,3] f32, lig_seq str
"""
from __future__ import annotations

import numpy as np


def load_npz_complex(path: str) -> dict:
    with np.load(path) as z:
        return {
            "rec_x": z["rec_x"],
            "rec_pos": z["rec_pos"],
            "rec_seq": str(z["rec_seq"]),
            "lig_x": z["lig_x"],
            "lig_pos": z["lig_pos"],
            "lig_seq": str(z["lig_seq"]),
        }
