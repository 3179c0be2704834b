"""The parameter bridge (dfmdock_tpu_torch/params.py): JAX pytree <-> port
state_dict, round trip exact, and the trained demo checkpoint driving the
port's ScoreNet to the JAX outputs."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import _torch_parity as tp
from dfmdock_tpu.cli.common import load_model as jax_load_model
from dfmdock_tpu.config import from_yaml as jax_from_yaml
from dfmdock_tpu.data.dataset import complex_to_batch
from dfmdock_tpu.models import ScoreNet as JaxScoreNet
from dfmdock_tpu_torch.config import ModelConfig
from dfmdock_tpu_torch.data.convert import load_npz_complex
from dfmdock_tpu_torch.models import ScoreNet
from dfmdock_tpu_torch.params import load_npz, to_flat, to_state_dict

DEMO = "ckpts/db5_demo"


def _round_trip(flat, cfg):
    net = ScoreNet(cfg)
    net.load_state_dict(to_state_dict(flat))  # strict: every key matched
    back = to_flat(net.state_dict())
    assert set(back) == set(flat)
    for k, v in flat.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_round_trip_random_init():
    jc, pc = tp.configs()
    _round_trip(tp.jax_flat(JaxScoreNet(jc).init(jax.random.PRNGKey(3))), pc)


def test_npz_checkpoint_loads(tmp_path):
    jc, pc = tp.configs()
    flat = tp.jax_flat(JaxScoreNet(jc).init(jax.random.PRNGKey(4)))
    np.savez(tmp_path / "w.npz", **flat)
    sd = load_npz(str(tmp_path / "w.npz"))
    net = ScoreNet(pc)
    net.load_state_dict(sd)
    np.testing.assert_array_equal(
        net.egnn[1].edge_mlp["l0"].weight.detach().numpy(),
        flat["egnn/1/edge_mlp/l0/w"].T)


@pytest.fixture(scope="module")
def demo():
    cfg = jax_from_yaml(f"{DEMO}/config.yaml")
    _, params = jax_load_model(f"{DEMO}/last", cfg)
    return cfg, params


def test_round_trip_demo_checkpoint(demo):
    cfg, params = demo
    flat = tp.jax_flat(params)
    assert len(flat) == 104
    _round_trip(flat, ModelConfig(**dataclasses.asdict(cfg.model)))


def test_demo_forward_matches_jax(demo):
    """Trained weights, full width, 1AVX padded to 448, t = 0.3, knn-only
    edges (deterministic): every output within 1e-4 of max |JAX| (f32 on
    both sides, summation order differs)."""
    cfg, params = demo
    model = dataclasses.replace(cfg.model, sample_size=0)
    raw = load_npz_complex("data/db5_npz/1AVX.npz")
    batch = complex_to_batch(raw)
    out_j = JaxScoreNet(model).apply(params, tp.jax_batch(batch, 0.3),
                                     jax.random.PRNGKey(0), predict=True)
    net = tp.port_net(ModelConfig(**dataclasses.asdict(model)), params)
    pb = tp.port_batch(batch)
    with torch.no_grad():
        out_p = net(pb, pb["pos"][None], 0.3)
    assert float(np.abs(np.asarray(out_j["f"])).max()) > 0
    for k in ("tr_score", "rot_score", "f", "energy", "ires"):
        tp.assert_close(out_p[k][0].numpy(), out_j[k], 1e-4, k)
    assert int(out_p["num_clashes"][0]) == int(out_j["num_clashes"])
