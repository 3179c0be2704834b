"""ROADMAP F7's tools on the CPU: the spread summary of
scripts/dfmdock_witness.py (`--summarize DIR... --spread TAG,...`) on
synthetic per-seed sweep rows, and the training arguments of
scripts/f7_runs.py against the protocol of
ckpts/db5_holdout_dfmdock_torch/README.md.
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "scripts"))
import dfmdock_witness as witness  # noqa: E402
import f7_runs  # noqa: E402

from dfmdock_tpu_torch.cli import train  # noqa: E402

SEEDS = (5, 6)


def poses(level, seed, k):
    """Three poses of complex number k: DockQ level + offsets, the second
    pose the lowest in energy."""
    base = level + 0.01 * seed + 0.001 * k
    return np.array([[base, 1.0], [base + 0.2, -3.0], [base - 0.1, 0.5]])


def write_sweeps(root, levels):
    """Per-pose CSVs as `--out-dir` writes them, for each tag at its
    (training, held-out) level, seeds SEEDS, into root/train and
    root/holdout.  Returns the two directories."""
    dirs = {name: os.path.join(root, name) for name in ("train", "holdout")}
    for tag, lv in levels.items():
        for (name, ids), level in zip((("train", witness.RECORD_ORDER),
                                       ("holdout", witness.HOLDOUT_ORDER)), lv):
            os.makedirs(dirs[name], exist_ok=True)
            for seed in SEEDS:
                path = os.path.join(dirs[name], f"port-cuda@{tag}_seed{seed}_{'-'.join(ids)}.csv")
                with open(path, "w") as f:
                    f.write("id,index,DockQ,energy\n")
                    for k, cid in enumerate(ids):
                        f.writelines(f"{cid},{i},{float(d)!r},{float(e)!r}\n"
                                     for i, (d, e) in enumerate(poses(level, seed, k)))
    return dirs["train"], dirs["holdout"]


def expected(level):
    """(mean DockQ, pick mean) of a tag at `level`, by hand: the poses'
    mean is base + 0.1 / 3, the pick is base + 0.2, base averaged over the
    four complexes and the seeds."""
    base = level + 0.01 * np.mean(SEEDS) + 0.001 * 1.5
    return base + 0.1 / 3, base + 0.2


LEVELS = {"a": (0.10, 0.02), "b": (0.20, 0.03), "c": (0.15, 0.01), "jax": (0.40, 0.025),
          "a-bf16": (0.30, 0.05)}


def test_spread_of_synthetic_runs(tmp_path, capsys):
    dirs = write_sweeps(str(tmp_path), LEVELS)
    out = witness.spread(witness.read_runs(dirs), ["a", "b", "c"], "jax")
    for i, name in enumerate(("training", "held-out")):
        got = out[name]
        want = {t: expected(LEVELS[t][i]) for t in ("a", "b", "c")}
        for t, (mean, pick) in want.items():
            assert got["runs"][t][:2] == pytest.approx((mean, pick), abs=1e-12), (name, t)
            assert got["runs"][t][2] == list(SEEDS)
        vals = np.array(list(want.values()))
        m, s = vals.mean(0), vals.std(0, ddof=1)
        ref = np.array(expected(LEVELS["jax"][i]))
        assert got["m"] == pytest.approx(tuple(m), abs=1e-12)
        assert got["s"] == pytest.approx(tuple(s), abs=1e-12)
        assert got["reference"] == pytest.approx(tuple(ref), abs=1e-12)
        assert got["z"] == pytest.approx(tuple((ref - m) / s), rel=1e-9)
        assert got["inside"] == bool(np.all(np.abs(ref - m) <= 2 * s))
        assert "a-bf16" not in got["runs"]  # beside the spread, not in it
    # the training levels put the reference 5 s above m; the held-out ones 0.5 s
    assert not out["training"]["inside"] and out["held-out"]["inside"]
    assert out["training"]["z"][0] == pytest.approx(5.0)
    assert out["held-out"]["z"][0] == pytest.approx(0.5)
    printed = capsys.readouterr().out
    assert "port-cuda@a-bf16 (beside it)" in printed
    assert "over 3 runs (a, b, c)" in printed and "outside m +- 2s" in printed


def test_summarize_cli_prints_the_spread(tmp_path, capsys):
    dirs = write_sweeps(str(tmp_path), LEVELS)
    assert witness.main(["--summarize", *dirs, "--spread", "a,b,c"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if "over 3 runs" in ln]
    assert len(lines) == 2
    assert "port-cuda@jax: mean" in lines[0] and "(+5.00 s)" in lines[0]
    assert "(+0.50 s)" in lines[1] and lines[1].endswith("inside m +- 2s")


def test_spread_needs_two_runs_and_the_reference(tmp_path):
    dirs = write_sweeps(str(tmp_path), {"a": (0.1, 0.1), "jax": (0.2, 0.2)})
    assert witness.spread(witness.read_runs(dirs), ["a", "b"], "jax") == {}


@pytest.mark.parametrize("spec, dtype", [("3", "float32"), ("1:bfloat16", "bfloat16")])
def test_f7_runs_train_at_the_protocol(spec, dtype):
    """Both halves of a run: the checkpoint README's arguments, the second
    resumed from the first's weights with the epochs already trained as
    the save offset; each parses to the record's experiment."""
    (seed, got_dtype), = f7_runs.parse_runs(spec)
    assert got_dtype == dtype
    tag = f7_runs.run_tag(seed, dtype)
    halves = [f7_runs.half_argv(seed, dtype, 400, h, "OUT", "W", "cuda") for h in (1, 2)]
    protocol = ["--lineage", "dfmdock", "--grad-energy", "--crop-size", "448",
                "--exclude-ids", "1QA9,7CEI,2SIC,1JPS", "--epochs", "400", "--seed", str(seed),
                "--log-every", "400", "--compute-dtype", dtype]
    for h, argv in enumerate(halves, 1):
        assert argv[:len(protocol)] == protocol
        args = train.parse_args(argv)
        assert args.ckpt_dir == os.path.join("W", tag, f"half{h}")
        assert args.metrics_json == os.path.join("OUT", tag, f"metrics_half{h}.jsonl")
        assert (args.pool_variants, args.pool_refresh, args.batch_size, args.lr,
                args.weight_decay, args.no_pool) == (2, 25, 1, 1e-4, 0.0, False)
        exp = train.experiment_config(args).experiment
        assert exp.grad_energy and not exp.use_contrastive_loss
    first, second = (train.parse_args(a) for a in halves)
    assert first.resume is None and first.save_offset == 0
    assert second.resume == os.path.join("W", tag, "half1", "weights.npz")
    assert second.save_offset == 400


def test_f7_runs_parse_runs():
    assert f7_runs.parse_runs("1,2,1:bfloat16") == [(1, "float32"), (2, "float32"),
                                                    (1, "bfloat16")]
    assert f7_runs.run_tag(1, "bfloat16") == "seed1-bf16"
    with pytest.raises(ValueError):
        f7_runs.parse_runs("1:float16")
