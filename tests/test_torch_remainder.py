"""The remaining modules of the port against their JAX functions on the CPU,
on the same numpy-seeded inputs:

- eval/tm.py (compute_tm, tm_loss, distogram_loss), geom (kabsch with and
  without weights, skew, the 6D pair) and features/frames.py: f32 on both
  sides, max |port - JAX| <= 1e-5 * max |JAX| (+1e-6; only the order of
  sums differs); kabsch's R within 1e-5 absolute (it comes from an SVD)
  and its t within 1e-4 rel (R's error times the centroid);
- relpos_onehot and sixd_bins_dense on a DB5 complex: exactly equal;
- NPZDataset[i] with and without ESM columns: every field exactly equal;
- the reference .pt reader on a synthetic file pickled through the port's
  torch_geometric stubs, read under either package's stubs, and the
  converter's npz; DIPSDataset and PinderDataset on synthetic files;
- param_counts and config_tree; profile_trace, StepTimer, WandbLogger;
- a synthetic Lightning .ckpt of each lineage, laid out with the names the
  reference uses (utils/torch_convert.py), through both packages'
  loaders: the port's state_dict equals the JAX tree bit for bit, and the
  two nets' forwards agree within 1e-5 of each output's largest element.
"""
import gzip
import json
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
from dfmdock_tpu.config import DFMDockConfig as JaxDFMDockConfig
from dfmdock_tpu.data import convert as jax_convert
from dfmdock_tpu.data import external as jax_external
from dfmdock_tpu.data.dataset import NPZDataset as JaxNPZDataset
from dfmdock_tpu.eval import tm as jax_tm
from dfmdock_tpu.features import frames as jax_frames
from dfmdock_tpu.features.positional import relpos_onehot as jax_relpos_onehot
from dfmdock_tpu.features.sixd import sixd_bins_dense as jax_sixd_bins_dense
from dfmdock_tpu.geom import rotations as jax_rot
from dfmdock_tpu.models import ScoreNet as JaxScoreNet
from dfmdock_tpu.models.dfmdock import DFMDockModel as JaxDFMDock
from dfmdock_tpu.utils import logging as jax_logging
from dfmdock_tpu.utils.torch_convert import load_lightning_checkpoint as jax_load_ckpt
from dfmdock_tpu_torch.cli.common import load_model
from dfmdock_tpu_torch.config import DFMDockConfig
from dfmdock_tpu_torch.data import convert, external
from dfmdock_tpu_torch.data.dataset import NPZDataset
from dfmdock_tpu_torch.eval import tm
from dfmdock_tpu_torch.features import frames
from dfmdock_tpu_torch.features.positional import relpos_onehot
from dfmdock_tpu_torch.features.sixd import sixd_bins_dense
from dfmdock_tpu_torch.geom import rotations as rot
from dfmdock_tpu_torch.models import DFMDockModel, ScoreNet
from dfmdock_tpu_torch.params import to_state_dict
from dfmdock_tpu_torch.utils import logging as plog
from dfmdock_tpu_torch.utils.torch_convert import load_lightning_checkpoint

REL = 1e-5
DB5 = "data/db5_npz"


def close(port, ref, name="", rel=REL):
    tp.assert_close(np.asarray(port), np.asarray(ref), rel, name)


def T(a):
    return torch.from_numpy(np.array(a))  # a writable copy


# ---- eval/tm.py -----------------------------------------------------------

def test_tm_scores_and_losses_match_jax():
    rng = np.random.RandomState(0)
    logits = rng.randn(9, 7, 64).astype(np.float32) * 2
    sq = (rng.rand(9, 7) * 40).astype(np.float32) ** 2
    dists = (rng.rand(9, 7) * 60).astype(np.float32)
    mask = (rng.rand(9, 7) > 0.3).astype(np.float32)
    close(tm.compute_tm(T(logits)), jax_tm.compute_tm(jnp.asarray(logits)), "compute_tm")
    close(tm.tm_loss(T(logits), T(sq)), jax_tm.tm_loss(jnp.asarray(logits), jnp.asarray(sq)),
          "tm_loss")
    close(tm.distogram_loss(T(logits), T(dists)),
          jax_tm.distogram_loss(jnp.asarray(logits), jnp.asarray(dists)), "distogram")
    close(tm.distogram_loss(T(logits), T(dists), pair_mask=T(mask)),
          jax_tm.distogram_loss(jnp.asarray(logits), jnp.asarray(dists),
                                pair_mask=jnp.asarray(mask)), "distogram masked")


# ---- geom -----------------------------------------------------------------

@pytest.mark.parametrize("weighted", [False, True])
def test_kabsch_matches_jax(weighted):
    rng = np.random.RandomState(3 + weighted)
    A = rng.randn(30, 3).astype(np.float32) * 5
    R0 = np.asarray(jax_rot.random_rotation_matrix(jax.random.PRNGKey(1)))
    B = (A @ R0.T + [1.0, -2.0, 3.0] + rng.randn(30, 3) * 0.1).astype(np.float32)
    w = (rng.rand(30) * (rng.rand(30) > 0.2)).astype(np.float32) if weighted else None
    R, t = rot.kabsch(T(A), T(B), None if w is None else T(w))
    Rj, tj = jax_rot.kabsch(jnp.asarray(A), jnp.asarray(B), None if w is None else jnp.asarray(w))
    np.testing.assert_allclose(R.numpy(), np.asarray(Rj), atol=1e-5)
    close(t, tj, "t", rel=1e-4)  # t = b_mean - R a_mean: R's error times |a_mean|
    assert float(torch.linalg.det(R)) == pytest.approx(1.0, abs=1e-5)


def test_kabsch_corrects_a_reflection():
    rng = np.random.RandomState(5)
    A = rng.randn(20, 3).astype(np.float32)
    B = A * np.float32([1, 1, -1])  # a mirror image: the best proper rotation
    R, _ = rot.kabsch(T(A), T(B))
    Rj, _ = jax_rot.kabsch(jnp.asarray(A), jnp.asarray(B))
    np.testing.assert_allclose(R.numpy(), np.asarray(Rj), atol=1e-5)
    assert float(torch.linalg.det(R)) == pytest.approx(1.0, abs=1e-5)


def test_skew_and_6d_match_jax():
    rng = np.random.RandomState(7)
    v = rng.randn(4, 5, 3).astype(np.float32)
    np.testing.assert_array_equal(rot.skew(T(v)).numpy(), np.asarray(jax_rot.skew(jnp.asarray(v))))
    w = rng.randn(4, 5, 3).astype(np.float32)
    np.testing.assert_allclose((rot.skew(T(v)) @ T(w)[..., None])[..., 0].numpy(),
                               np.cross(v, w), atol=1e-5)
    d6 = rng.randn(6, 6).astype(np.float32)
    m = rot.rotation_6d_to_matrix(T(d6))
    close(m, jax_rot.rotation_6d_to_matrix(jnp.asarray(d6)), "6d -> matrix")
    np.testing.assert_allclose((m @ m.transpose(-1, -2)).numpy(), np.broadcast_to(np.eye(3), m.shape),
                               atol=1e-5)
    np.testing.assert_array_equal(rot.matrix_to_rotation_6d(m).numpy(),
                                  np.asarray(jax_rot.matrix_to_rotation_6d(jnp.asarray(m.numpy()))))
    close(rot.rotation_6d_to_matrix(rot.matrix_to_rotation_6d(m)), m, "round trip")


# ---- features -------------------------------------------------------------

@pytest.fixture(scope="module")
def complex_1qa9():
    return NPZDataset(DB5).load_raw(NPZDataset(DB5).ids.index("1QA9"))


def test_frames_and_pair_features_match_jax(complex_1qa9):
    pos = np.concatenate([complex_1qa9["rec_pos"], complex_1qa9["lig_pos"]]).astype(np.float32)
    R = frames.residue_frames(T(pos))
    Rj = jax_frames.residue_frames(jnp.asarray(pos))
    close(R, Rj, "residue_frames")
    close(frames.rbf(T(pos[:, 1, 0])), jax_frames.rbf(jnp.asarray(pos[:, 1, 0])), "rbf")
    f = frames.pair_features(T(pos[:, 1]), R)
    fj = jax_frames.pair_features(jnp.asarray(pos[:, 1]), Rj)
    assert f.shape == (pos.shape[0], pos.shape[0], 25)
    close(f, fj, "pair_features")


def test_relpos_onehot_and_sixd_bins_dense_equal_jax(complex_1qa9):
    b = tp.jax_pad_complex(complex_1qa9["rec_x"], complex_1qa9["lig_x"],
                           complex_1qa9["rec_pos"], complex_1qa9["lig_pos"])
    n = int(b["node_mask"].sum())
    res_id, asym_id, pos = b["res_id"][:n], b["asym_id"][:n], b["pos"][:n]
    np.testing.assert_array_equal(
        relpos_onehot(T(res_id), T(asym_id)).numpy(),
        np.asarray(jax_relpos_onehot(jnp.asarray(res_id), jnp.asarray(asym_id))))
    got = sixd_bins_dense(T(pos))
    want = jax_sixd_bins_dense(jnp.asarray(pos))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.shape == (n, n)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---- data -----------------------------------------------------------------

@pytest.mark.parametrize("use_esm", [True, False])
def test_npz_dataset_getitem_matches_jax(use_esm):
    got = NPZDataset(DB5, use_esm=use_esm)[0]
    want = JaxNPZDataset(DB5, use_esm=use_esm)[0]
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], str):
            assert got[k] == want[k], k
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    assert got["x"].shape[-1] == (1301 if use_esm else 21)


def _synthetic_pt(path, seed):
    """A reference-layout .pt complex pickled through the port's stubs."""
    rng = np.random.RandomState(seed)
    mods = convert.pyg_stub_modules()
    with pytest.MonkeyPatch.context() as m:
        for name in convert.PYG_MODULES:
            m.setitem(sys.modules, name, mods[name])
        data = mods["torch_geometric.data.hetero_data"].HeteroData()
        store = mods["torch_geometric.data.storage"].NodeStorage
        data._node_store_dict = {
            chain: store(_mapping={"x": torch.randn(n, 1280, generator=torch.Generator().manual_seed(seed)),
                                   "pos": T(rng.randn(n, 3, 3).astype(np.float32)),
                                   "seq": "".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWY"), n))})
            for chain, n in (("receptor", 11), ("ligand", 7))}
        torch.save(data, path)
    return path


@pytest.fixture
def no_pyg():
    """No torch_geometric module (real or stub) imported during the test;
    the modules there were before it are restored after it."""
    saved = {n: sys.modules.pop(n) for n in convert.PYG_MODULES if n in sys.modules}
    yield
    for n in convert.PYG_MODULES:
        sys.modules.pop(n, None)
    sys.modules.update(saved)


@pytest.mark.parametrize("stubs", ["port", "jax"])
def test_load_pt_complex_matches_jax(tmp_path, stubs, no_pyg):
    path = _synthetic_pt(str(tmp_path / "1abc.pt"), seed=1)
    if stubs == "jax":
        jax_convert._install_pyg_stubs()
    got = convert.load_pt_complex(path)
    want = jax_convert.load_pt_complex(path)
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], str):
            assert got[k] == want[k]
        else:
            assert got[k].dtype == np.float32
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["rec_pos"].shape == (11, 3, 3) and got["lig_x"].shape == (7, 1280)


def test_convert_main_writes_jax_npz(tmp_path, no_pyg):
    src = tmp_path / "pt"
    src.mkdir()
    for i, cid in enumerate(("1abc", "2xyz")):
        _synthetic_pt(str(src / f"{cid}.pt"), seed=10 + i)
    (src / "test.txt").write_text("2xyz\n9zzz\n1abc\n")
    convert.main(["--src", str(src), "--dst", str(tmp_path / "port")])
    jax_convert.convert_file(str(src / "1abc.pt"), str(tmp_path / "jax" / "1abc.npz"))
    assert (tmp_path / "port" / "test.txt").read_text() == "2xyz\n1abc\n"
    got = convert.load_npz_complex(str(tmp_path / "port" / "1abc.npz"))
    want = jax_convert.load_npz_complex(str(tmp_path / "jax" / "1abc.npz"))
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    assert NPZDataset(str(tmp_path / "port")).ids == ["2xyz", "1abc"]


def test_dips_dataset_matches_jax(tmp_path, no_pyg):
    d = tmp_path / "dips"
    d.mkdir()
    _synthetic_pt(str(d / "ab_1abc.pdb1_0.pt"), seed=3)
    lf = tmp_path / "list.txt"
    lf.write_text("ab/1abc.pdb1_0.dill\n")
    got = external.DIPSDataset(str(d), str(lf)).load_raw(0)
    want = jax_external.DIPSDataset(str(d), str(lf)).load_raw(0)
    assert got["id"] == want["id"] == "ab_1abc.pdb1_0"
    np.testing.assert_array_equal(got["rec_x"], want["rec_x"])
    with pytest.raises(FileNotFoundError, match="DIPS data not found"):
        external.DIPSDataset(str(tmp_path / "nope"), str(lf))


def test_pinder_dataset_matches_jax(tmp_path):
    d = {"rec_seq": "MKV", "lig_seq": "AC", "rec_pos": np.zeros((3, 3, 3), np.float32),
         "lig_pos": np.ones((2, 3, 3), np.float32), "rec_x": np.zeros((3, 1280), np.float32),
         "lig_x": np.zeros((2, 1280), np.float32)}
    with gzip.open(tmp_path / "1abc__A_B.pkl.gz", "wb") as f:
        pickle.dump(d, f)
    ds = external.PinderDataset(str(tmp_path))
    assert len(ds) == 1
    got, want = ds.load_raw(0), jax_external.PinderDataset(str(tmp_path)).load_raw(0)
    assert got["id"] == want["id"] == "1abc__A_B" and got["rec_seq"] == "MKV"
    for k in ("rec_x", "lig_x", "rec_pos", "lig_pos"):
        np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(FileNotFoundError, match="PINDER data not found"):
        external.PinderDataset(str(tmp_path / "nope"))


# ---- utils/logging.py -----------------------------------------------------

@pytest.mark.parametrize("lineage", ["mlsb", "dfmdock"])
def test_param_counts_and_config_tree_match_jax(lineage):
    jc, pc = tp.configs()
    jnet, pnet = (JaxScoreNet(jc), ScoreNet(pc)) if lineage == "mlsb" else (JaxDFMDock(jc),
                                                                           DFMDockModel(pc))
    want = jax_logging.param_counts(jnet.init(jax.random.PRNGKey(0)))
    assert plog.param_counts(pnet) == want
    assert want["non_trainable"] == pc.inner_dim // 2  # the Fourier buffer
    assert plog.config_tree(DFMDockConfig()) == jax_logging.config_tree(JaxDFMDockConfig())
    assert plog.config_to_dict(DFMDockConfig()) == jax_logging.config_to_dict(JaxDFMDockConfig())


def test_profile_trace_step_timer_and_wandb(tmp_path):
    with plog.profile_trace(str(tmp_path / "prof")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "prof" / plog.TRACE_FILE) as f:
        assert json.load(f)["traceEvents"]
    with plog.profile_trace(None) as prof:
        assert prof is None
    timer = plog.StepTimer(str(tmp_path / "steps.jsonl"))
    for i in range(3):
        timer.step({"loss": torch.tensor(float(i))})
    timer.close()
    assert timer.steps_per_sec > 0
    with open(tmp_path / "steps.jsonl") as f:
        assert [json.loads(line)["loss"] for line in f] == [0.0, 1.0, 2.0]
    w = plog.WandbLogger(config={"a": 1})  # wandb is not installed: a no-op
    w.log({"loss": 1.0}, step=1)
    w.finish()


# ---- utils/torch_convert.py: Lightning checkpoints ------------------------

def _reference_state_dict(params, lineage: str) -> dict:
    """The JAX parameter tree under the reference nets' state_dict names
    (the inverse of utils/torch_convert.py's map), 'net.'-prefixed."""
    sd = {}

    def lin(name, p):
        sd[f"{name}.weight"] = np.asarray(p["w"]).T
        if "b" in p:
            sd[f"{name}.bias"] = np.asarray(p["b"])

    def norm(name, p):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = np.asarray(p["g"]), np.asarray(p["b"])
        if "mean_scale" in p:
            sd[f"{name}.mean_scale"] = np.asarray(p["mean_scale"])

    def head(name, p, last):
        lin(f"{name}.0", p["l0"]), norm(f"{name}.1", p["ln"]), lin(f"{name}.{last}", p["l1"])

    for k in ("single_embed", "spatial_embed", "positional_embed"):
        lin(k, params[k])
    for i, layer in enumerate(params["egnn"]):
        pre = f"network.EGNN_{i}.egcl"
        lin(f"{pre}.edge_mlp.0", layer["edge_mlp"]["l0"])
        lin(f"{pre}.edge_mlp.2", layer["edge_mlp"]["l1"])
        lin(f"{pre}.node_mlp.0", layer["node_mlp"]["l0"])
        norm(f"{pre}.node_mlp.1", layer["node_mlp"]["gn"])
        lin(f"{pre}.node_mlp.3", layer["node_mlp"]["l1"])
        lin(f"{pre}.att_mlp.0", layer["att_mlp"]["l0"])
        if "coord_mlp" in layer:
            lin(f"{pre}.coord_mlp.0", layer["coord_mlp"]["l0"])
            lin(f"{pre}.coord_mlp.2", layer["coord_mlp"]["l1"])
    for name in ("to_energy",) + (("to_force", "to_dist", "to_confidence")
                                  if lineage == "dfmdock" else ()):
        head(name, params[name], 3)
    for j, k in enumerate(("l0", "l1", "l2")):
        lin(f"to_ires.{2 * j}", params["to_ires"][k])
    sd["t_embed.0.W"] = np.asarray(params["t_embed"]["W"])
    lin("t_embed.1", params["t_embed"]["l0"])
    for name in ("tr_scale", "rot_scale"):
        head(name, params[name], 4)
    return {"net." + k: T(v) for k, v in sd.items()}


@pytest.mark.parametrize("lineage", ["mlsb", "dfmdock"])
def test_lightning_checkpoint_matches_jax(tmp_path, lineage):
    jc, pc = tp.configs(sample_size=0, depth=3)
    jnet = JaxScoreNet(jc) if lineage == "mlsb" else JaxDFMDock(jc)
    params = jnet.init(jax.random.PRNGKey(4))
    path = str(tmp_path / "last.ckpt")
    sd = _reference_state_dict(params, lineage)
    sd["extra.weight"] = torch.zeros(2)  # not under net.: ignored by both loaders
    torch.save({"state_dict": sd, "hyper_parameters": {"model": {"depth": 3}},
                "epoch": 7}, path)

    jparams, hp = jax_load_ckpt(path, lineage=lineage)
    state, hp_p = load_lightning_checkpoint(path, lineage=lineage)
    assert hp_p == hp
    want = to_state_dict(tp.jax_flat(jparams))
    assert sorted(state) == sorted(want)
    for k, v in want.items():
        torch.testing.assert_close(state[k], v, rtol=0, atol=0)

    net = load_model(path, DFMDockConfig(model=pc), torch.device("cpu"), lineage=lineage)
    b = tp.padded(40, 24, seed=13)
    out_j = jnet.apply(jax.tree_util.tree_map(jnp.asarray, jparams), tp.jax_batch(b, 0.3),
                       jax.random.PRNGKey(1), predict=True)
    pb = tp.port_batch(b)
    with torch.no_grad():
        out_p = net(pb, pb["pos"][None], 0.3)
    for k in ("tr_score", "rot_score", "energy"):
        close(out_p[k][0].numpy(), out_j[k], k)
