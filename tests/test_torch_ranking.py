"""Pose ranking and the sampler's options vs the JAX package, small width on
the CPU: the multi-draw ranking scores and the re-ranker (knn-only edges,
so both sides see the same graph in every draw), the clash force, a Heun
ODE trajectory from a shared start pose, and the trajectory PDB writer.

Tolerances: rel 1e-4 of the largest JAX value (f32 on both sides; the
scores pass through a full forward, the trajectory through 8 forwards);
the re-ranker's scores atol 1e-3 (z-scores over 3 poses) and the same
best pose; PDB text identical."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
from dfmdock_tpu.cli.dock import _reranker_scores as jax_reranker_scores
from dfmdock_tpu.cli.sweep import _multi_draw_scores as jax_multi_draw_scores
from dfmdock_tpu.config import R3Config as JR3Config, SamplerConfig as JSamplerConfig
from dfmdock_tpu.config import SO3Config as JSO3Config
from dfmdock_tpu.data.dataset import complex_to_batch as jax_complex_to_batch
from dfmdock_tpu.data.pdb_io import save_trajectory as jax_save_trajectory
from dfmdock_tpu.diffusion import R3Diffuser as JR3, SO3Diffuser as JSO3
from dfmdock_tpu.models import ScoreNet as JaxScoreNet
from dfmdock_tpu.sampler import EMSampler as JaxEMSampler
from dfmdock_tpu.sampler.em import clash_force as jax_clash_force
from dfmdock_tpu_torch.cli.dock import DEFAULT_RERANKER, _reranker_scores
from dfmdock_tpu_torch.cli.sweep import _multi_draw_scores
from dfmdock_tpu_torch.config import R3Config, SamplerConfig, SO3Config
from dfmdock_tpu_torch.data.pdb_io import save_trajectory
from dfmdock_tpu_torch.diffusion import R3Diffuser, SO3Diffuser
from dfmdock_tpu_torch.sampler import EMSampler
from dfmdock_tpu_torch.sampler.em import clash_force

AA = "ACDEFGHIKLMNPQRSTVWY"


def raw_complex(n_rec=40, n_lig=24, seed=13):
    """A raw complex dict (npz layout) whose node features fit the small
    config: lm_embed_dim 32 = 11 features + the 21-way one-hot."""
    rec_x, lig_x, rec_pos, lig_pos = tp.make_complex(n_rec, n_lig, 11, seed)
    rng = np.random.RandomState(seed)
    seq = lambda n: "".join(rng.choice(list(AA), n))
    return {"id": "toy", "rec_x": rec_x, "lig_x": lig_x, "rec_pos": rec_pos,
            "lig_pos": lig_pos, "rec_seq": seq(n_rec), "lig_seq": seq(n_lig)}


@pytest.fixture(scope="module")
def ranking_setup():
    """knn-only nets (JAX and port, same params) and three poses of the toy
    complex padded to 64: native and two ligand shifts."""
    jc, pc = tp.configs(sample_size=0)
    pc = dataclasses.replace(pc, use_pallas=True, edge_table_kernel=True)
    params = JaxScoreNet(jc).init(jax.random.PRNGKey(0))
    # interface logits of order 1 (at init they are ~0 and every pose's icons
    # is ln 2 to within an ulp, which the re-ranker's z-scores would amplify)
    params["to_ires"] = jax.tree_util.tree_map(lambda w: w * 30.0, params["to_ires"])
    raw = raw_complex()
    native = jax_complex_to_batch(raw, pad_to=64)["pos"]
    poses = np.stack([native] * 3)
    poses[1, 40:64] += np.float32([1.5, -1.0, 0.5])
    poses[2, 40:64] += np.float32([-4.0, 5.0, 3.0])
    return jc, pc, params, raw, poses


def test_multi_draw_scores_match_jax(ranking_setup):
    jc, pc, params, raw, poses = ranking_setup
    ref = jax_multi_draw_scores(JaxScoreNet(jc), params, raw, jnp.asarray(poses), 64, 2, 0,
                                t_eval=0.3)
    out = _multi_draw_scores(tp.port_net(pc, params), raw, poses, 64, 2, 0,
                             torch.device("cpu"), t_eval=0.3)
    for key in ("energy", "icons", "snorm"):
        tp.assert_close(out[key], ref[key], 1e-4, key)
        assert np.std(ref[key]) > 1e-4, key  # the poses score apart


def test_reranker_scores_match_jax(ranking_setup):
    jc, pc, params, raw, poses = ranking_setup
    rows = [{"num_clashes": c} for c in (0, 3, 1)]
    ref = jax_reranker_scores(JaxScoreNet(jc), params, raw, {"pos": jnp.asarray(poses)},
                              rows, DEFAULT_RERANKER, 1, 0)
    out = _reranker_scores(tp.port_net(pc, params), raw, {"pos": poses}, rows,
                           DEFAULT_RERANKER, 1, 0, torch.device("cpu"))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-3)
    assert int(np.argmax(out)) == int(np.argmax(ref))


def test_clash_force_matches_jax():
    """Ligand moved onto the receptor so that backbone atoms clash (< 4 A)."""
    b = tp.padded(30, 20, seed=3)
    pos = np.stack([b["pos"], b["pos"]])
    pos[0, 30:50] += b["pos"][10, 1] - b["pos"][30, 1]
    pos[1, 30:50] += b["pos"][20, 1] - b["pos"][35, 1] + np.float32([0.5, 0.5, 0.0])
    out = clash_force(torch.from_numpy(pos), torch.from_numpy(b["lig_mask"]),
                      torch.from_numpy(b["node_mask"])).numpy()
    for p in range(2):
        ref = np.asarray(jax_clash_force(jnp.asarray(pos[p]), jnp.asarray(b["lig_mask"]),
                                         jnp.asarray(b["node_mask"])))
        assert np.abs(ref).max() > 1e-2
        tp.assert_close(out[p], ref, 1e-4, "clash force")


def test_heun_trajectory_matches_jax():
    """4 Heun steps on the probability-flow ODE with the clash force, from a
    shared start pose, knn-only edges, trajectory recorded: every frame,
    the final pose and scores within 1e-4 of max |JAX|.  R3 max_sigma is
    cut to 1 A, as in test_torch_sampler.test_ode_trajectory_matches_jax."""
    jc, pc = tp.configs(sample_size=0)
    params = JaxScoreNet(jc).init(jax.random.PRNGKey(0))
    b = tp.padded(40, 24, seed=9)
    scfg = dict(num_steps=4, ode=True, integrator="heun", use_clash_force=True)
    jsam = JaxEMSampler(JaxScoreNet(jc), JR3(JR3Config(max_sigma=1.0)), JSO3(JSO3Config()),
                        JSamplerConfig(**scfg))
    init_pos = b["pos"].copy()
    init_pos[40:64] += np.float32([4.0, -3.0, 2.0])
    init = (init_pos, np.float32([[4.0, -3.0, 2.0]]), np.float32([[0.2, 0.1, -0.3]]))
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    out_j = jsam.sample_one(params, jb, jax.random.PRNGKey(3), record_trajectory=True,
                            init=tuple(map(jnp.asarray, init)))
    psam = EMSampler(tp.port_net(pc, params), R3Diffuser(R3Config(max_sigma=1.0)),
                     SO3Diffuser(SO3Config()), SamplerConfig(**scfg))
    out_p = psam.sample(tp.port_batch(b), 1, torch.Generator().manual_seed(0),
                        init=tuple(torch.from_numpy(x)[None] for x in init),
                        record_trajectory=True)
    assert out_p["trajectory"].shape == (1, 4) + b["pos"].shape
    assert np.abs(np.asarray(out_j["pos"]) - init_pos).max() > 1e-3
    for k in ("trajectory", "pos", "tr_update", "tr_score", "rot_score", "energy"):
        tp.assert_close(out_p[k][0].numpy(), out_j[k], 1e-4, k)


def test_heun_needs_ode():
    with pytest.raises(ValueError, match="ODE"):
        EMSampler(None, None, None, SamplerConfig(integrator="heun"))


def test_save_trajectory_matches_jax(tmp_path):
    raw = raw_complex(12, 7, seed=4)
    rng = np.random.RandomState(0)
    frames = [np.concatenate([raw["rec_pos"], raw["lig_pos"]]) + rng.randn(1, 1, 3) * s
              for s in (0.0, 1.0, 2.0)]
    rec, lig = [f[:12] for f in frames], [f[12:] for f in frames]
    jax_save_trajectory(str(tmp_path / "j.pdb"), rec, lig, raw["rec_seq"], raw["lig_seq"])
    save_trajectory(str(tmp_path / "p.pdb"), rec, lig, raw["rec_seq"], raw["lig_seq"])
    text = (tmp_path / "p.pdb").read_text()
    assert text == (tmp_path / "j.pdb").read_text()
    assert text.count("ENDMDL") == 3 and os.path.getsize(tmp_path / "p.pdb") > 0
