"""The port's dock CLI on the CPU: the JAX CLI's CSV columns, a PDB of the
best pose, and no quiet fallback to the CPU when CUDA is asked for."""
import csv
import os

import numpy as np
import pytest
import torch

from dfmdock_tpu.cli.common import dock_complex as jax_dock_complex
from dfmdock_tpu_torch.cli import dock
from dfmdock_tpu_torch.data.convert import load_npz_complex

NPZ = "data/db5_npz/1AVX.npz"


def _jax_columns(raw, n):
    """The record keys the JAX CLI writes, from its own dock_complex (the
    sampler is replaced by fixed results; only the CSV layout is read)."""
    n_pad = 448
    results = {"pos": np.zeros((n, n_pad, 3, 3), np.float32) + np.arange(3)[:, None],
               "energy": np.zeros(n, np.float32),
               "num_clashes": np.zeros(n, np.int32)}
    rows, _, _ = jax_dock_complex(None, None, raw, None, n,
                                  native=(raw["rec_pos"], raw["lig_pos"]),
                                  run_fn=lambda *_: results)
    return list(rows[0])


@pytest.mark.parametrize("exact", [False, True])
def test_cli_writes_jax_columns(tmp_path, exact):
    argv = ["--npz", NPZ, "--num-samples", "2", "--num-steps", "2", "--device", "cpu",
            "--out-dir", str(tmp_path)] + (["--exact"] if exact else [])
    rows = dock.main(argv)
    with open(tmp_path / "metrics.csv") as f:
        reader = csv.DictReader(f)
        written = list(reader)
    raw = load_npz_complex(NPZ)
    raw["id"] = "1AVX"
    assert reader.fieldnames == _jax_columns(raw, 2)
    assert len(written) == len(rows) == 2
    assert all(np.isfinite(float(r["energy"])) for r in written)
    best = int(np.argmin([r["energy"] for r in rows]))
    assert os.path.exists(tmp_path / f"1AVX_{best}.pdb")


def test_cli_refuses_missing_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dock.main(["--npz", NPZ, "--num-samples", "1", "--out-dir", str(tmp_path)])
    assert not os.path.exists(tmp_path / "metrics.csv")
