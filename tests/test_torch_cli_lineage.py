"""The port's CLIs on the CPU for the DFMDock lineage and Picard latency
mode: `sweep --lineage dfmdock` writes the JAX sweep's columns and refuses
`--energy-draws > 1` (the JAX sweep's ranking draws cannot run on that
lineage); `dock --picard-iters` docks and refuses what the JAX dock refuses."""
import csv

import numpy as np
import pytest

import dfmdock_tpu.cli.sweep as jax_sweep
from dfmdock_tpu_torch.cli import dock, sweep
from test_torch_cli import _fake_jax_cli

DFMDOCK_NPZ = "ckpts/db5_holdout_dfmdock/weights.npz"


def _header(path):
    with open(path) as f:
        reader = csv.DictReader(f)
        return reader.fieldnames, list(reader)


def test_sweep_dfmdock_lineage_writes_jax_columns(tmp_path, monkeypatch):
    """The trained DFMDock-lineage weights over one small complex, two
    poses: finite energies, DockQ per pose, the JAX sweep's columns."""
    common = ["--num-samples", "2", "--num-steps", "2", "--ids", "1QA9", "--lineage",
              "dfmdock"]
    out = tmp_path / "port.csv"
    rows = sweep.main(common + ["--ckpt", DFMDOCK_NPZ, "--device", "cpu",
                                "--out-csv", str(out)])
    cols, written = _header(out)
    assert [r["id"] for r in written] == ["1QA9"] * 2 and len(rows) == 2
    assert all(np.isfinite(float(r[c])) for r in written for c in ("energy", "DockQ"))
    _fake_jax_cli(monkeypatch, jax_sweep, 2)
    jax_sweep.main(common + ["--out-csv", str(tmp_path / "jax.csv")])
    assert cols == _header(tmp_path / "jax.csv")[0]


def test_sweep_dfmdock_refuses_energy_draws(tmp_path, capsys):
    with pytest.raises(SystemExit):
        sweep.main(["--lineage", "dfmdock", "--energy-draws", "2", "--ids", "1QA9",
                    "--device", "cpu", "--out-csv", str(tmp_path / "s.csv")])
    assert "not available with --lineage dfmdock" in capsys.readouterr().err
    assert not (tmp_path / "s.csv").exists()


def test_dock_picard_iters_runs(tmp_path):
    rows = dock.main(["--npz", "data/db5_npz/1QA9.npz", "--num-samples", "2",
                      "--num-steps", "3", "--picard-iters", "2", "--device", "cpu",
                      "--out-dir", str(tmp_path)])
    cols, written = _header(tmp_path / "metrics.csv")
    assert len(written) == len(rows) == 2 and "DockQ" in cols
    assert all(np.isfinite(float(r["energy"])) for r in written)


@pytest.mark.parametrize("flags,message", [
    (["--num-samples", "5"], "single-pose latency mode"),
    (["--integrator", "heun"], "its own scheme"),
])
def test_dock_picard_iters_refusals(tmp_path, capsys, flags, message):
    with pytest.raises(SystemExit):
        dock.main(["--npz", "data/db5_npz/1QA9.npz", "--picard-iters", "2", "--device",
                   "cpu", "--out-dir", str(tmp_path)] + flags)
    assert message in capsys.readouterr().err


def test_dock_picard_iters_refuses_clash_force(tmp_path):
    with pytest.raises(ValueError, match="clash force"):
        dock.main(["--npz", "data/db5_npz/1QA9.npz", "--num-samples", "1", "--picard-iters",
                   "2", "--use-clash-force", "--device", "cpu", "--out-dir", str(tmp_path)])
