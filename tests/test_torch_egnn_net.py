"""The port's DFMDock lineage (EGNNNet / DFMDockModel) vs the JAX package's
f32 XLA forward, small width, on both port routes (eager `--exact`, and the
kernel path, which on CPU tensors runs the kernels' plain versions); the
parameter bridge over the EGNNNet pytree.  The trained weights at full
width: tests/test_torch_weights.py.

Tolerance: max |port - JAX| <= 1e-4 * max |JAX| per output (f32 on both
sides; the port sums the pair heads over receptor rows x ligand columns,
JAX over 64-row chunks of all N x N pairs); num_clashes exact."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import _torch_parity as tp
from dfmdock_tpu.models.dfmdock import DFMDockModel as JaxDFMDock
from dfmdock_tpu.models.egnn_net import EGNNNet as JaxEGNNNet
from dfmdock_tpu_torch.models import DFMDockModel, EGNNNet
from dfmdock_tpu_torch.params import to_flat, to_state_dict

SCORES = ("tr_score", "rot_score", "f")
OUTPUTS = SCORES + ("energy", "confidence_logits", "ires_logits")


def _port(cls, pc, params):
    net = cls(pc)
    net.load_state_dict(to_state_dict(tp.jax_flat(params)))  # strict
    return net.eval()


def _compare(out_p, outs_j, scores_only=False):
    names = SCORES if scores_only else OUTPUTS
    for i, out_j in enumerate(outs_j):
        assert set(out_j) == set(names) | ({"num_clashes"} if not scores_only else set())
        for k in names:
            tp.assert_close(out_p[k][i].numpy(), out_j[k], 1e-4, k)
        if not scores_only:
            assert int(out_p["num_clashes"][i]) == int(out_j["num_clashes"])
    assert set(out_p) == set(outs_j[0])


def test_round_trip_random_init():
    """EGNNNet's pytree (pair heads [2C+1, C] without bias, LayerNorms, the
    Fourier buffer, agg-only EGCL layers, the distogram head) maps onto the
    port's state_dict key for key and back bit for bit."""
    jc, pc = tp.configs()
    flat = tp.jax_flat(JaxEGNNNet(jc).init(jax.random.PRNGKey(3)))
    net = EGNNNet(pc)
    net.load_state_dict(to_state_dict(flat))  # strict: every key matched
    back = to_flat(net.state_dict())
    assert set(back) == set(flat)
    assert not any("coord_mlp" in k for k in flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


@pytest.mark.parametrize("kernel_path", [False, True])
@pytest.mark.parametrize("scores_only", [False, True])
@pytest.mark.parametrize("agg", ["mean", "sum"])
def test_forward_knn_only(agg, scores_only, kernel_path):
    """DFMDockModel (ligand-centred EGNNNet), knn-only edges, one pose."""
    jc, pc = tp.configs(sample_size=0, agg=agg)
    pc = dataclasses.replace(pc, use_pallas=kernel_path, edge_table_kernel=kernel_path)
    params = JaxDFMDock(jc).init(jax.random.PRNGKey(0))
    b = tp.padded(40, 24, seed=13)
    out_j = JaxDFMDock(jc).apply(params, tp.jax_batch(b, 0.3), jax.random.PRNGKey(1),
                                 predict=True, scores_only=scores_only)
    assert np.abs(np.asarray(out_j["f"])).max() > 0
    net = _port(DFMDockModel, pc, params)
    pb = tp.port_batch(b)
    with torch.no_grad():
        out_p = net(pb, pb["pos"][None], 0.3, scores_only=scores_only)
    _compare(out_p, [out_j], scores_only)


@pytest.mark.parametrize("kernel_path", [False, True])
@pytest.mark.parametrize("agg", ["mean", "sum"])
def test_forward_sampled_edges_two_poses(agg, kernel_path):
    """knn 20 + 40 sampled edges with JAX's own Gumbel noise injected, two
    poses batched (the second with its ligand moved), each against its own
    JAX call; one t per pose."""
    jc, pc = tp.configs(agg=agg)
    pc = dataclasses.replace(pc, use_pallas=kernel_path, edge_table_kernel=kernel_path)
    params = JaxDFMDock(jc).init(jax.random.PRNGKey(5))
    b = tp.padded(70, 50, seed=21)
    n = b["pos"].shape[0]
    pos2 = b["pos"].copy()
    pos2[70:120] += np.float32([2.0, -1.0, 0.5])
    outs_j, gumbels = [], []
    for i, (pos, t) in enumerate(((b["pos"], 0.4), (pos2, 0.8))):
        key = jax.random.PRNGKey(30 + i)
        outs_j.append(JaxDFMDock(jc).apply(params, tp.jax_batch({**b, "pos": pos}, t), key,
                                           predict=True))
        k_edges, _ = jax.random.split(key)
        gumbels.append(np.asarray(jax.random.gumbel(k_edges, (n, n))))
    net = _port(DFMDockModel, pc, params)
    pb = tp.port_batch(b)
    pos = torch.from_numpy(np.stack([b["pos"], pos2]))
    with torch.no_grad():
        out_p = net(pb, pos, torch.tensor([0.4, 0.8]), gumbel=torch.from_numpy(np.stack(gumbels)))
    _compare(out_p, outs_j)


def test_egnn_net_does_not_centre():
    """EGNNNet takes its input as it is (JAX EGNNNet), DFMDockModel centres
    on the ligand's backbone mean: the two differ by that shift alone."""
    jc, pc = tp.configs(sample_size=0)
    params = JaxEGNNNet(jc).init(jax.random.PRNGKey(2))
    b = tp.padded(30, 20, seed=5)
    out_j = JaxEGNNNet(jc).apply(params, tp.jax_batch(b, 0.5), jax.random.PRNGKey(0),
                                 predict=True)
    pb = tp.port_batch(b)
    with torch.no_grad():
        out_p = _port(EGNNNet, pc, params)(pb, pb["pos"][None], 0.5)
        out_c = _port(DFMDockModel, pc, params)(pb, pb["pos"][None], 0.5)
    _compare(out_p, [out_j])
    assert not torch.allclose(out_p["rot_score"], out_c["rot_score"])
