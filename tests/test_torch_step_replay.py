"""chip_smoke.py's path for a failing card-vs-CPU training step (phase 9m's
DFMDock bf16 check, ROADMAP F6): the step's case kept in a file and replayed
in float64, here on the CPU alone at a tiny crop (crop 64, seeded weights).

The kept file holds the weights, the pool row, the perturbation, both
gradient sets and the check's bounds; the replay names the arrays with the
largest card-vs-CPU gap against the check's bound on it and which side
lies farther from the float64 reading.  A "card" side
with one array moved by 1.0 must be found as that array, on the card's
side, and the arrays where both sides agree as neither.  The float64
replay is the same step as the float32 one: every gradient within 1e-4 of
its array's largest, with a floor of 1e-6 of the largest gradient of all
for arrays that are zero by construction (float32 rounding; the bf16 step
lies up to ~30% of an array's largest away at these seeded weights).

A failing check raises its own failures even where keeping or replaying
the step fails.  On the card (marked `cuda`, skipped without one) the
replay runs on both sides, its edges selected by select_topk's kernel from
float32 distances; the card's float64 gradients lie within 1e-8 of the
largest gradient of the CPU's (float64 sums in another order), and an
array moved by ten times the largest gradient of all is the worst against
the bf16 check's bound (over 100 times it; the card's bf16 gradients lie
within about one bound of the CPU's) and found on the card's side."""
import importlib.util
import os
import shutil

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)


def tiny_step(tmp_path):
    """The check's flags at crop 64 over 1QA9 alone, and seeded weights."""
    data = tmp_path / "data"
    data.mkdir()
    shutil.copy(os.path.join(ROOT, "data", "db5_npz", "1QA9.npz"), data)
    flags = ["--lineage", "dfmdock", "--crop-size", "64", "--grad-energy",
             "--data-dir", str(data)] + cs.BF16
    cpu = torch.device("cpu")
    torch.manual_seed(0)
    weights = cs.load_model(None, cs.step_config(flags, cpu), cpu, lineage="dfmdock").state_dict()
    return flags, weights


def test_keep_and_replay_failing_step(tmp_path):
    flags, weights = tiny_step(tmp_path)
    dev = torch.device("cpu")
    cfg = cs.step_config(flags, dev)
    row, inj = cs.step_row(flags, dev)
    terms, cpu = cs.step_gradients(cfg, "dfmdock", weights, row, inj, dev)
    assert all(torch.isfinite(v).all() for v in terms.values())
    moved = "egnn.1.edge_mlp.l1.weight"
    card = {k: v.clone() for k, v in cpu.items()}
    card[moved] += 1.0
    path, rows, ref = cs.keep_failing_step("dfmdock bf16", "dfmdock", flags, weights, row,
                                           inj, card, cpu, dev, out_dir=str(tmp_path / "kept"))
    f64 = ref["cpu"]
    kept = torch.load(path, weights_only=False)
    assert kept["flags"] == flags and torch.equal(kept["cpu"][moved], cpu[moved])
    assert kept["tols"] == (cs.TRAIN_LOSS_REL, cs.TRAIN_GRAD_REL, cs.TRAIN_GRAD_FLOOR)
    assert rows[0]["array"] == moved and rows[0]["farther"] == "card"
    assert all(r["farther"] == "neither" for r in rows[1:])
    cfg32 = cs.step_config(flags, dev, compute_dtype="float32")
    _, f32 = cs.step_gradients(cfg32, "dfmdock", weights, row, inj, dev)
    assert torch.get_default_dtype() == torch.float32
    top = max(g.abs().max() for g in f64.values())
    for k, g in f64.items():
        assert g.dtype == torch.float64
        assert (f32[k].double() - g).abs().max() <= 1e-4 * g.abs().max() + 1e-6 * top, k


def test_failing_check_raises_its_own_failures(tmp_path, monkeypatch):
    flags, weights = tiny_step(tmp_path)

    def broken(*args, **kwargs):
        raise ValueError("the replay broke")

    monkeypatch.setattr(cs, "keep_failing_step", broken)
    with pytest.raises(AssertionError, match="train dfmdock bf16: gradient of "):
        # bounds below zero: every gradient array fails the check
        cs.train_step_parity("dfmdock bf16", "dfmdock", flags, weights, torch.device("cpu"),
                             tols=(-1.0, -1.0, -1.0))


@pytest.mark.cuda
def test_replay_failing_step_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the replay's card side runs only there")
    flags, weights = tiny_step(tmp_path)
    dev = torch.device("cuda")
    row, inj = cs.step_row(flags, dev)
    launches = cs.select_topk.launches
    _, card = cs.step_gradients(cs.step_config(flags, dev), "dfmdock", weights, row, inj, dev)
    _, cpu = cs.step_gradients(cs.step_config(flags, torch.device("cpu")), "dfmdock", weights,
                               row, inj, torch.device("cpu"))
    moved = "egnn.1.edge_mlp.l1.weight"
    top = max(g.abs().max() for g in cpu.values())
    card[moved] += 10 * top
    before = cs.select_topk.launches
    tols = (cs.BF16_TRAIN_LOSS_REL, cs.BF16_TRAIN_GRAD_REL, cs.BF16_TRAIN_GRAD_FLOOR)
    path, rows, ref = cs.keep_failing_step("dfmdock bf16", "dfmdock", flags, weights, row, inj,
                                           card, cpu, dev, tols, out_dir=str(tmp_path / "kept"))
    assert before > launches and cs.select_topk.launches > before
    assert rows[0]["array"] == moved and rows[0]["farther"] == "card"
    assert rows[0]["of_bound"] > 100 and all(r["of_bound"] < 100 for r in rows[1:])
    top = max(g.abs().max() for g in ref["cpu"].values())
    for k, g in ref["cpu"].items():
        assert ref["cuda"][k].dtype == torch.float64
        assert (ref["cuda"][k] - g).abs().max() <= 1e-8 * top, k
