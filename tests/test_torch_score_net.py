"""The port's ScoreNet forward vs JAX ScoreNet(ModelConfig(...)) f32 on all
outputs, small width, on both port paths (eager `--exact`, and the kernel
path, which on CPU tensors runs the kernels' plain versions).

Tolerance: max |port - JAX| <= 1e-4 * max |JAX| per output (f32 on both
sides; only the summation order differs); num_clashes exact."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import _torch_parity as tp
from dfmdock_tpu.models import ScoreNet as JaxScoreNet

OUTPUTS = ("tr_score", "rot_score", "f", "energy", "ires")


def _compare(out_p, outs_j):
    for i, out_j in enumerate(outs_j):
        for k in OUTPUTS:
            tp.assert_close(out_p[k][i].numpy(), out_j[k], 1e-4, k)
        assert int(out_p["num_clashes"][i]) == int(out_j["num_clashes"])


@pytest.mark.parametrize("kernel_path", [False, True])
@pytest.mark.parametrize("t", [0.1, 0.9])
def test_forward_knn_only(kernel_path, t):
    jc, pc = tp.configs(sample_size=0)
    pc = dataclasses.replace(pc, use_pallas=kernel_path, edge_table_kernel=kernel_path)
    params = JaxScoreNet(jc).init(jax.random.PRNGKey(0))
    b = tp.padded(40, 24, seed=13)
    out_j = JaxScoreNet(jc).apply(params, tp.jax_batch(b, t), jax.random.PRNGKey(1),
                                  predict=True)
    assert np.abs(np.asarray(out_j["f"])).max() > 0
    net = tp.port_net(pc, params)
    pb = tp.port_batch(b)
    with torch.no_grad():
        out_p = net(pb, pb["pos"][None], t)
        scores = net(pb, pb["pos"][None], t, scores_only=True)
    _compare(out_p, [out_j])
    assert set(scores) == {"tr_score", "rot_score", "f"}
    torch.testing.assert_close(scores["tr_score"], out_p["tr_score"], rtol=0, atol=0)


def test_forward_sampled_edges_two_poses():
    """knn 20 + 40 sampled edges with JAX's own Gumbel noise injected, two
    poses batched on the port's leading axis, each against its own JAX call."""
    jc, pc = tp.configs()
    pc = dataclasses.replace(pc, use_pallas=True, edge_table_kernel=True)
    params = JaxScoreNet(jc).init(jax.random.PRNGKey(5))
    b = tp.padded(70, 50, seed=21)
    n = b["pos"].shape[0]
    pos2 = b["pos"].copy()
    pos2[70:120] += np.float32([2.0, -1.0, 0.5])
    outs_j, gumbels = [], []
    for i, pos in enumerate((b["pos"], pos2)):
        key = jax.random.PRNGKey(30 + i)
        outs_j.append(JaxScoreNet(jc).apply(
            params, tp.jax_batch({**b, "pos": pos}, 0.4), key, predict=True))
        k_edges, _ = jax.random.split(key)
        gumbels.append(np.asarray(jax.random.gumbel(k_edges, (n, n))))
    net = tp.port_net(pc, params)
    pb = tp.port_batch(b)
    pos = torch.from_numpy(np.stack([b["pos"], pos2]))
    with torch.no_grad():
        out_p = net(pb, pos, 0.4, gumbel=torch.from_numpy(np.stack(gumbels)))
    _compare(out_p, outs_j)


@pytest.mark.parametrize("route,shift", [
    (dict(edge_table_kernel=False), 2.0),                     # edge_bins + torch geometry
    (dict(edge_table_kernel=True, select_kernel=True), 2.0),  # select_topk
    (dict(edge_table_kernel=True), 100.0),                    # energy: one pose all masked
])
def test_kernel_path_routes_match_jax(route, shift):
    """Each route of the kernel path (the kernels' plain versions on CPU
    tensors) against the JAX f32 XLA forward, two poses batched, JAX's own
    Gumbel noise injected so that both select the same edges.  With the
    ligand moved 100 A along z, the second pose has no receptor-ligand pair
    within the cutoff: its energy is the empty masked mean, 0."""
    jc, pc = tp.configs()
    pc = dataclasses.replace(pc, use_pallas=True, **route)
    params = JaxScoreNet(jc).init(jax.random.PRNGKey(4))
    b = tp.padded(60, 40, seed=17)
    n = b["pos"].shape[0]
    pos2 = b["pos"].copy()
    pos2[60:100] += np.float32([0.5, -1.0, shift])
    outs_j, gumbels = [], []
    for i, pos in enumerate((b["pos"], pos2)):
        key = jax.random.PRNGKey(40 + i)
        outs_j.append(JaxScoreNet(jc).apply(
            params, tp.jax_batch({**b, "pos": pos}, 0.3), key, predict=True))
        k_edges, _ = jax.random.split(key)
        gumbels.append(np.asarray(jax.random.gumbel(k_edges, (n, n))))
    net = tp.port_net(pc, params)
    pb = tp.port_batch(b)
    pos = torch.from_numpy(np.stack([b["pos"], pos2]))
    with torch.no_grad():
        out_p = net(pb, pos, 0.3, gumbel=torch.from_numpy(np.stack(gumbels)))
    _compare(out_p, outs_j)
    if shift > 20:
        assert float(out_p["energy"][1]) == 0.0 and float(outs_j[1]["energy"]) == 0.0
