"""The port's multi-GPU path (dfmdock_tpu_torch/parallel) on the CPU, under
gloo, against the one-process path:

- the pose-parallel sampler at world size 2 equals world size 1 pose for
  pose, over one reverse SDE step and a 3-step probability-flow ODE with
  kNN-only edges (sample_size 0), where no per-rank draw reaches the poses:
  each output within 1e-5 of its largest element (f32; the two runs batch
  2 and 4 poses, which may reorder a reduction);
- `--dp` at world size 1 is bit-equal to the plain dock through the CLI;
- the data-parallel training step at world size 2 over one row a rank, each
  row's draws injected (the `injected` route of train/losses.py): its
  all-reduced gradients equal the one-process train_step's over the same
  two rows, each array within 1e-5 of its largest element, and its
  metrics within 1e-6 rel;
- ranks draw different t from one seed;
- the JAX package's --dp refusals, in the port's words;
- dryrun_multichip(2) in a fresh process; the sweep CLI at world size 2.

Spawned ranks join through a FileStore in a temporary directory (no TCP
port) and every spawn has a time limit, so a hung rank fails its test.
"""
import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_dp
import _torch_parity as tp
from dfmdock_tpu_torch.cli import dock, sweep, train
from dfmdock_tpu_torch.config import ModelConfig
from dfmdock_tpu_torch.models import ScoreNet
from dfmdock_tpu_torch.parallel import init_world, rank_seed, spawn
from dfmdock_tpu_torch.parallel import world as world_mod
from dfmdock_tpu_torch.parallel.mesh import make_pose_parallel_sampler, stack_batches
from dfmdock_tpu_torch.parallel.world import World
from dfmdock_tpu_torch.train.pool import MODEL_KEYS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_TIMEOUT_S = 180
SAMPLE_REL = 1e-5
GRAD_REL = 1e-5
DEMO = os.path.join(ROOT, "ckpts", "db5_demo", "weights.npz")
CPU = torch.device("cpu")


def _draw(seed: int) -> dict:
    rng = np.random.RandomState(seed)
    return {"t": np.float32(0.2 + 0.3 * seed),
            "tr_update": rng.randn(1, 3).astype(np.float32) * 3,
            "tr_score_gt": rng.randn(1, 3).astype(np.float32), "tr_scale": np.float32(0.4),
            "rot_update": rng.randn(1, 3).astype(np.float32) * 0.5,
            "rot_score_gt": rng.randn(1, 3).astype(np.float32), "rot_scale": np.float32(0.8)}


@pytest.fixture(scope="module")
def runs():
    """One spawned world of 2 ranks and one in-process world of 1 rank doing
    the same work (tests/_torch_dp.py), and the one-process training step."""
    model_kw = {**tp.SMALL, "sample_size": 0}
    weights = ScoreNet(ModelConfig(**model_kw)).init_weights(
        torch.Generator().manual_seed(0)).state_dict()
    batch = tp.padded(40, 24, seed=9)
    rows = [{k: tp.padded(36, 28, seed=s)[k] for k in MODEL_KEYS} for s in (4, 5)]
    draws = [_draw(1), _draw(2)]
    args = (model_kw, weights, batch, rows, draws)
    two = spawn(_torch_dp.dp_rank, 2, args, timeout=SPAWN_TIMEOUT_S)
    with init_world(CPU) as world:
        one = _torch_dp.dp_rank(world, *args)
    return {"two": two, "one": one, "single": _torch_dp.single_step(model_kw, weights, rows, draws)}


def _within(got, want, rel, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max() + 1e-12, (name, err, np.abs(want).max())


@pytest.mark.parametrize("run", range(len(_torch_dp.SAMPLER_RUNS)))
def test_pose_parallel_matches_one_rank(runs, run):
    two, one = runs["two"]["sample"][run], runs["one"]["sample"][run]
    assert set(two) == set(one)
    for k in one:
        assert two[k].shape[0] == _torch_dp.NUM_POSES, k
        if k == "num_clashes":
            np.testing.assert_array_equal(two[k], one[k])
        else:
            _within(two[k], one[k], SAMPLE_REL, k)
    # the ligands moved from their start (the ODE) and the poses differ
    assert np.abs(one["pos"][0] - one["pos"][1]).max() > 1e-2


def test_dp_step_matches_one_process(runs):
    metrics, grads = runs["single"]
    for name, g in grads.items():
        _within(runs["two"]["grads"][name], g, GRAD_REL, name)
    assert max(float(g.abs().max()) for g in grads.values()) > 0
    for k, v in metrics.items():
        assert runs["two"]["metrics"][k] == pytest.approx(v, rel=1e-6), k
    # at one rank the same step is the plain step's, bit for bit
    for name, g in grads.items():
        torch.testing.assert_close(runs["one"]["grads"][name], g, rtol=0, atol=0)


def test_ranks_draw_different_t(runs):
    t0, t1 = runs["two"]["t"]
    assert t0 != t1
    assert rank_seed(5, 0) != rank_seed(5, 1) != rank_seed(6, 1)


def test_dp_dock_one_rank_bit_equal_to_plain(tmp_path):
    common = ["--npz", "data/db5_npz/1QA9.npz", "--ckpt", DEMO, "--device", "cpu",
              "--num-samples", "2", "--num-steps", "2", "--write-all-poses"]
    plain = dock.main(common + ["--out-dir", str(tmp_path / "plain")])
    dp = dock.main(common + ["--out-dir", str(tmp_path / "dp"), "--dp"])
    assert dp == plain
    assert plain[0] != plain[1]  # two poses, docked apart
    for name in sorted(os.listdir(tmp_path / "plain")):
        with open(tmp_path / "plain" / name) as f, open(tmp_path / "dp" / name) as g:
            assert f.read() == g.read(), name


def test_dp_sweep_two_ranks(tmp_path, monkeypatch):
    """The sweep CLI over two spawned gloo ranks: rank 0 writes one CSV with
    every pose of the complex."""
    monkeypatch.setattr(world_mod, "spawn", functools.partial(spawn, timeout=SPAWN_TIMEOUT_S))
    out = str(tmp_path / "sweep.csv")
    rows = sweep.main(["--ids", "1QA9", "--ckpt", DEMO, "--device", "cpu", "--num-samples",
                       "4", "--num-steps", "2", "--out-csv", out, "--dp", "--world-size", "2"])
    assert [r["index"] for r in rows] == ["0", "1", "2", "3"]
    assert np.isfinite([r["energy"] for r in rows]).all()
    with open(out) as f:
        assert len(f.readlines()) == 5


@pytest.mark.parametrize("cli,flags,message", [
    (dock, ["--npz", "data/db5_npz/1QA9.npz", "--num-samples", "3", "--world-size", "2"],
     "divisible by the device count (2)"),
    (sweep, ["--num-samples", "3", "--world-size", "2"], "divisible by the device count (2)"),
    (dock, ["--npz", "data/db5_npz/1QA9.npz", "--num-samples", "1", "--picard-iters", "2"],
     "--picard-iters does not support --dp"),
    (train, ["--batch-size", "1"], "--dp requires --batch-size to be a multiple of the 1"),
    (train, ["--batch-size", "3", "--world-size", "2"],
     "--dp requires --batch-size to be a multiple of the 2"),
    (train, ["--batch-size", "2", "--no-pool"], "drop --no-pool"),
])
def test_dp_refusals(cli, flags, message, capsys):
    with pytest.raises(SystemExit):
        cli.main(["--device", "cpu", "--dp"] + flags)
    assert message in capsys.readouterr().err


def test_pose_parallel_refuses_indivisible():
    with pytest.raises(ValueError, match=r"num_samples \(3\) divisible by the device count \(2\)"):
        make_pose_parallel_sampler(None, 3, World(0, 2, CPU))


def test_stack_batches_drops_strings():
    b = [{"x": np.ones((2, 3), np.float32) * i, "id": f"c{i}"} for i in range(3)]
    out = stack_batches(b)
    assert set(out) == {"x"} and out["x"].shape == (3, 2, 3)
    np.testing.assert_array_equal(out["x"][:, 0, 0], [0, 1, 2])


def test_dryrun_multichip_fresh_process():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    r = subprocess.run([sys.executable, "-c", "from dfmdock_tpu_torch.parallel.dryrun import "
                        "dryrun_multichip; dryrun_multichip(2)"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "dryrun_multichip(2): train loss" in r.stdout
