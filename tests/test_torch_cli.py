"""The port's dock and sweep CLIs on the CPU: the JAX CLIs' CSV columns
(the JAX CLI run with its sampler and scorers replaced by fixed results,
so that only its CSV layout is read), a PDB of the best pose, --resume,
and no quiet fallback to the CPU when CUDA is asked for."""
import csv
import os

import numpy as np
import pytest
import torch

import dfmdock_tpu.cli.dock as jax_dock
import dfmdock_tpu.cli.sweep as jax_sweep
from dfmdock_tpu.cli.common import dock_complex as jax_dock_complex
from dfmdock_tpu_torch.cli import dock, sweep
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


def _fake_jax_cli(monkeypatch, module, n):
    """Replace the JAX CLI's model, sampler and ranking scores by fixed
    values of the right shapes."""
    def runner(*_args, **_kw):
        def run(_params, batch, _key):
            n_pad = batch["pos"].shape[0]
            return {"pos": np.zeros((n, n_pad, 3, 3), np.float32) + np.arange(3)[:, None],
                    "energy": np.arange(n, dtype=np.float32),
                    "num_clashes": np.zeros(n, np.int32)}
        return run

    scores = lambda *_a, **_k: {k: np.arange(n, dtype=np.float64) for k in
                                ("energy", "icons", "snorm")}
    monkeypatch.setattr(module, "load_model", lambda *a, **k: (None, None))
    monkeypatch.setattr(module, "build_sampler", lambda *a, **k: None)
    monkeypatch.setattr(module, "make_runner", runner)
    monkeypatch.setattr(jax_sweep, "_multi_draw_scores", scores)


def _header(path):
    with open(path) as f:
        reader = csv.DictReader(f)
        return reader.fieldnames, list(reader)


@pytest.mark.parametrize("flags", [["--rank-by", "reranker", "--reranker-draws", "1"],
                                   ["--energy-draws", "2"]])
def test_cli_ranking_writes_jax_columns(tmp_path, monkeypatch, flags):
    """--rank-by reranker adds rerank_score; --energy-draws adds
    energy_first_draw, icons and snorm, in the JAX CLI's order."""
    npz = "data/db5_npz/1QA9.npz"
    common = ["--npz", npz, "--num-samples", "2", "--num-steps", "2"] + flags
    rows = dock.main(common + ["--device", "cpu", "--out-dir", str(tmp_path / "port")])
    _fake_jax_cli(monkeypatch, jax_dock, 2)
    jax_dock.main(common + ["--out-dir", str(tmp_path / "jax")])
    port_cols, written = _header(tmp_path / "port" / "metrics.csv")
    jax_cols, _ = _header(tmp_path / "jax" / "metrics.csv")
    assert port_cols == jax_cols
    added = ["rerank_score"] if "reranker" in flags else ["energy_first_draw", "icons", "snorm"]
    assert port_cols[-len(added):] == added
    assert len(written) == len(rows) == 2
    assert all(np.isfinite(float(r[c])) for r in written for c in port_cols[2:])


def test_sweep_writes_jax_columns_and_resumes(tmp_path, monkeypatch, capsys):
    """Two complexes, then --resume over three: only the third is docked,
    the first two rows stay as written."""
    common = ["--num-samples", "2", "--num-steps", "2"]
    out = tmp_path / "port.csv"
    sweep.main(common + ["--ids", "1QA9,7CEI", "--device", "cpu", "--out-csv", str(out)])
    port_cols, first = _header(out)
    assert [r["id"] for r in first] == ["1QA9"] * 2 + ["7CEI"] * 2
    capsys.readouterr()
    sweep.main(common + ["--ids", "1QA9,7CEI,4POU", "--device", "cpu", "--resume",
                         "--out-csv", str(out)])
    log = capsys.readouterr().out
    assert "4POU done" in log and "1QA9 done" not in log and "7CEI done" not in log
    cols, resumed = _header(out)
    assert resumed[:4] == first and [r["id"] for r in resumed[4:]] == ["4POU"] * 2
    _fake_jax_cli(monkeypatch, jax_sweep, 2)
    jax_sweep.main(common + ["--ids", "1QA9,7CEI", "--out-csv", str(tmp_path / "jax.csv")])
    jax_cols, _ = _header(tmp_path / "jax.csv")
    assert port_cols == cols == jax_cols
