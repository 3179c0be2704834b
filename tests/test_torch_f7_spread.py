"""ROADMAP F7's and db5_demo's reproduction tools on the CPU: the spread summary of
scripts/dfmdock_witness.py (`--summarize DIR... --spread TAG,...`) on
synthetic per-seed sweep rows (three runs, and F7's five with one held-out
set missing), the training arguments of
scripts/f7_runs.py against the protocols of
ckpts/db5_holdout_dfmdock_torch/README.md and ckpts/db5_demo/README.md, and
the db5_demo summary's paired difference and verdict on synthetic 24-complex
sweeps.
"""
import os
import shlex
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
    (training, held-out) level (None: that set not swept), seeds SEEDS,
    into root/train and root/holdout.  Returns the two directories."""
    dirs = {name: os.path.join(root, name) for name in ("train", "holdout")}
    for name in dirs.values():
        os.makedirs(name, exist_ok=True)
    for tag, lv in levels.items():
        for (name, ids), level in zip((("train", witness.RECORD_ORDER),
                                       ("holdout", witness.HOLDOUT_ORDER)), lv):
            if level is None:  # this set not swept for this tag
                continue
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


# F7's full sample: five float32 runs, the second (as seed 0) never swept
# on the held-out set, a bf16 run beside them and untrained weights swept
# on the held-out set alone
LEVELS5 = {"s11": (0.10, 0.020), "s0": (0.20, None), "s1": (0.15, 0.030), "s2": (0.12, 0.025),
           "s3": (0.18, 0.010), "jax": (0.16, 0.022), "s1-bf16": (0.14, 0.020),
           "untrained": (None, 0.005)}


def test_spread_of_five_runs_with_four_held_out(tmp_path, capsys):
    dirs = write_sweeps(str(tmp_path), LEVELS5)
    tags = ["s11", "s0", "s1", "s2", "s3"]
    out = witness.spread(witness.read_runs(dirs), tags, "jax")
    for i, (name, counted) in enumerate((("training", tags),
                                         ("held-out", ["s11", "s1", "s2", "s3"]))):
        got = out[name]
        assert list(got["runs"]) == counted
        vals = np.array([expected(LEVELS5[t][i]) for t in counted])
        m, s = vals.mean(0), vals.std(0, ddof=1)
        ref = np.array(expected(LEVELS5["jax"][i]))
        assert got["m"] == pytest.approx(tuple(m), abs=1e-12)
        assert got["s"] == pytest.approx(tuple(s), abs=1e-12)
        assert got["z"] == pytest.approx(tuple((ref - m) / s), rel=1e-9)
        assert got["inside"] == bool(np.all(np.abs(ref - m) <= 2 * s))
    assert out["training"]["inside"] and out["held-out"]["inside"]
    printed = capsys.readouterr().out
    assert "over 5 runs (s11, s0, s1, s2, s3)" in printed
    assert "over 4 runs (s11, s1, s2, s3)" in printed
    assert "port-cuda@untrained (beside it)" in printed
    assert "held-out set: port-cuda@s0" not in printed
    assert "training set: port-cuda@untrained" not in printed


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


DEMO_README = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "ckpts", "db5_demo", "README.md")


def demo_record_args():
    """The training CLI's arguments of the record's command in
    ckpts/db5_demo/README.md."""
    with open(DEMO_README) as f:
        text = f.read().replace("\\\n", " ")
    line, = (ln for ln in text.splitlines() if "dfmdock_tpu.cli.train" in ln)
    return train.parse_args(shlex.split(line.split("dfmdock_tpu.cli.train", 1)[1]))


def test_db5_demo_trains_at_the_record_command():
    """Two halves of 1000 epochs at the record's flags and seed, every 500
    epochs saved, the second resumed from the first's epoch999 weights
    with the epochs already trained as the save offset."""
    rec = demo_record_args()
    assert (rec.epochs, rec.seed, rec.crop_size) == (2000, 41, 448)
    halves = [train.parse_args(f7_runs.half_argv(41, "float32", 1000, h, "OUT", "W", "cuda",
                                                 "db5_demo")) for h in (1, 2)]
    keep = ("data_dir", "lineage", "crop_size", "lr", "grad_energy", "use_contrastive_loss",
            "use_confidence_loss", "use_dist_loss", "no_interface_loss", "compute_dtype",
            "exclude_ids", "batch_size", "no_pool", "pool_variants", "pool_refresh",
            "weight_decay", "contrastive_weight", "contrastive_margin", "contrastive_t_max",
            "contrastive_negatives", "contrastive_clash_negatives", "seed")
    for h, args in enumerate(halves, 1):
        assert {k: getattr(args, k) for k in keep} == {k: getattr(rec, k) for k in keep}
        assert (args.epochs, args.log_every, args.save_every) == (1000, 400, 500)
        assert args.ckpt_dir == os.path.join("W", "seed41", f"half{h}")
        assert args.metrics_json == os.path.join("OUT", "seed41", f"metrics_half{h}.jsonl")
        assert train.experiment_config(args) == train.experiment_config(rec)
    assert sum(a.epochs for a in halves) == rec.epochs
    first, second = halves
    assert first.resume is None and first.save_offset == 0
    assert second.resume == os.path.join("ckpts", "db5_demo_torch", "epoch999", "weights.npz")
    assert second.save_offset == 1000
    assert f7_runs.parse_runs(f7_runs.PROTOCOLS["db5_demo"].runs) == [(41, "float32")]
    # F7's protocol stays the default
    assert f7_runs.half_argv(3, "float32", 400, 1, "O", "W", "cuda") == f7_runs.half_argv(
        3, "float32", 400, 1, "O", "W", "cuda", "dfmdock_holdout")
    assert "--save-every" not in f7_runs.half_argv(3, "float32", 400, 2, "O", "W", "cuda")


DEMO_IDS = [f"C{k:02d}" for k in range(24)]
DEMO_SEEDS = (5, 6, 7)


def write_demo_sweeps(root, levels):
    """Sweep CSVs as the sweep CLI writes them, TAG_seedN.csv, 24 complexes
    x 3 poses: DockQ level + 0.02 seed^2 + offsets, the lowest energy on
    the second pose."""
    for tag, level in levels.items():
        for seed in DEMO_SEEDS:
            with open(os.path.join(root, f"{tag}_seed{seed}.csv"), "w") as f:
                f.write("id,DockQ,energy,index\n")
                for cid in DEMO_IDS:
                    base = level(seed) + 0.002 * int(cid[1:])
                    f.writelines(f"{cid},{d!r},{e!r},{i}\n" for i, (d, e) in enumerate(
                        [(base, 1.0), (base + 0.3, -2.0), (base - 0.1, 0.0)]))


@pytest.mark.parametrize("gap, reproduced", [(0.01, True), (0.2, False)])
def test_db5_demo_summary(tmp_path, capsys, gap, reproduced):
    """The paired difference jax - torch over the seeds, its standard
    error, and the verdict against eval_all.csv's bootstrap margins."""
    levels = {"jax": lambda s: 0.3 + 0.02 * s * s / 25,
              "torch": lambda s: 0.3 - gap + 0.01 * s}
    write_demo_sweeps(str(tmp_path), levels)
    out = f7_runs.demo_summary(str(tmp_path))
    base = np.mean([0.002 * k for k in range(24)])
    # per seed: the mean over poses is base + 0.2 / 3 above the level, the
    # pick base + 0.3, and a pick is acceptable+ where its DockQ >= 0.23
    per = {tag: np.array([(lv(s) + base + 0.2 / 3, lv(s) + base + 0.3,
                           sum(lv(s) + 0.002 * k + 0.3 >= 0.23 for k in range(24)))
                          for s in DEMO_SEEDS]) for tag, lv in levels.items()}
    d = per["jax"] - per["torch"]
    assert out["seeds"] == list(DEMO_SEEDS)
    assert out["torch"] == pytest.approx(per["torch"].mean(0).tolist(), abs=1e-12)
    assert out["jax"] == pytest.approx(per["jax"].mean(0).tolist(), abs=1e-12)
    assert out["diff"] == pytest.approx(d.mean(0).tolist(), abs=1e-12)
    assert out["se"] == pytest.approx((d.std(0, ddof=1) / np.sqrt(3)).tolist(), abs=1e-12)
    assert out["margin"] == pytest.approx([0.0512, 0.1282], abs=1e-4)
    assert out["reproduced"] is reproduced
    printed = capsys.readouterr().out
    assert ("# verdict: reproduced" in printed) is reproduced
    assert ("F8 opens" in printed) is not reproduced
    assert f7_runs.main(["--protocol", "db5_demo", "--summarize", str(tmp_path)]) == 0
