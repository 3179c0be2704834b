"""The port's fused edge selection (ops/select_topk) vs the JAX package's
Pallas select_topk_fused (interpret mode), both given the same y = masked
logits + jax.random.gumbel built by the JAX ops; the port's select_edges
against select_topk_plain and the JAX package's select_edges on the same
Gumbel noise (the CUDA kernel against its plain version is in
test_torch_cuda_kernels.py).

Exact: idx and edge_mask (selection only compares values; both sides break
ties to the lower index)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfmdock_tpu.models.edges import select_edges as jax_select_edges
from dfmdock_tpu.ops.select_topk import _NEG_INF, select_topk_fused
from dfmdock_tpu_torch.models.edges import select_edges, select_y
from dfmdock_tpu_torch.ops.select_topk import select_topk, select_topk_plain


def make_dist(n_tot, n_valid, seed=7, with_ties=False):
    """CA distances of a random-walk chain (as tests/test_select_topk.py);
    `with_ties` rounds them to multiples of 4 A."""
    rng = np.random.RandomState(seed)
    ca = np.cumsum(rng.randn(n_tot, 3) * 2 + [3.8, 0, 0], axis=0)
    d = np.linalg.norm(ca[:, None] - ca[None, :], axis=-1).astype(np.float32)
    if with_ties:
        d = np.round(d / 4.0) * 4.0
    return d, np.arange(n_tot) < n_valid


def jax_y(key, dist, mask):
    """select_topk_fused's own precompute: valid-masked -3 log d + Gumbel."""
    n = dist.shape[0]
    logits = -3.0 * jnp.log(jnp.maximum(jnp.asarray(dist), 1e-10))
    y = jnp.where(jnp.asarray(mask)[None, :], logits, _NEG_INF) + jax.random.gumbel(key, (n, n))
    return np.asarray(y)


@pytest.mark.parametrize("n_tot,n_valid,ties,sample_size", [
    pytest.param(128, 128, False, 40, id="128-128-False"),  # full
    pytest.param(128, 100, False, 40, id="128-100-False"),  # padded
    pytest.param(64, 25, False, 40, id="64-25-False"),  # tiny: fewer than knn + sample valid
    pytest.param(128, 128, True, 40, id="128-128-True"),  # forced distance ties
    pytest.param(128, 100, True, 40, id="128-100-True-s40"),  # ties and padding
    pytest.param(128, 100, True, 0, id="128-100-True-s0"),
    pytest.param(64, 64, True, 0, id="64-64-True-s0"),  # kNN alone, ties
    pytest.param(64, 25, False, 0, id="64-25-s0"),  # kNN alone, fewer than knn valid
    # wider rows, as the sweep pads (the CUDA kernel's warp holds N / 32 a lane)
    pytest.param(256, 230, False, 40, id="256-230-s40"),
    pytest.param(256, 230, False, 0, id="256-230-s0"),
    pytest.param(512, 480, False, 40, id="512-480-s40"),
    pytest.param(512, 480, False, 0, id="512-480-s0"),
])
def test_plain_matches_jax_kernel(n_tot, n_valid, ties, sample_size):
    idx_p, em_p, idx_j, em_j = [], [], [], []
    ys, dists = [], []
    for pose in range(2):
        d, mask = make_dist(n_tot, n_valid, seed=7 + pose, with_ties=ties)
        key = jax.random.PRNGKey(3 + pose)
        idx, em = select_topk_fused(key, jnp.asarray(d), jnp.asarray(mask),
                                    sample_size=sample_size)
        idx_j.append(np.asarray(idx))
        em_j.append(np.asarray(em))
        ys.append(jax_y(key, d, mask))
        dists.append(d)
    idx_p, em_p = select_topk_plain(torch.from_numpy(np.stack(dists)),
                                    torch.from_numpy(np.stack(ys)), torch.from_numpy(mask),
                                    sample_size=sample_size)
    idx_j, em_j = np.stack(idx_j), np.stack(em_j)
    np.testing.assert_array_equal(em_p.numpy(), em_j)
    on = em_j > 0.5
    np.testing.assert_array_equal(idx_p.numpy()[on], idx_j[on])
    assert on.sum() > 0


@pytest.mark.parametrize("n_valid", [128, 100])
def test_select_route_matches_topk_route(n_valid):
    """The port's select_edges (one route: select_topk on every device)
    against select_topk_plain on the keys select_y builds and against the
    JAX package's select_edges, JAX's own Gumbel draw injected."""
    d, mask = make_dist(128, n_valid, seed=11)
    dists = np.stack([d, d * 1.5])
    node_mask = torch.from_numpy(mask)
    keys = [jax.random.PRNGKey(1), jax.random.PRNGKey(2)]
    gumbel = np.stack([np.array(jax.random.gumbel(k, (128, 128))) for k in keys])
    idx_t, em_t = select_edges(torch.from_numpy(dists), node_mask,
                               gumbel=torch.from_numpy(gumbel))
    y = select_y(torch.from_numpy(dists), node_mask, torch.from_numpy(gumbel))
    idx_p, em_p = select_topk_plain(torch.from_numpy(dists), y, node_mask)
    assert torch.equal(idx_t, idx_p) and torch.equal(em_t, em_p)
    for pose, k in enumerate(keys):
        idx_j, em_j = jax_select_edges(k, jnp.asarray(dists[pose]), jnp.asarray(mask))
        np.testing.assert_array_equal(idx_t[pose].numpy(), np.asarray(idx_j))
        np.testing.assert_array_equal(em_t[pose].numpy(), np.asarray(em_j))


def test_wrapper_on_cpu_runs_plain_and_counts_nothing():
    d, mask = make_dist(64, 64)
    y = torch.from_numpy(jax_y(jax.random.PRNGKey(0), d, mask))
    before = select_topk.launches
    out = select_topk(torch.from_numpy(d), y, torch.from_numpy(mask))
    ref = select_topk_plain(torch.from_numpy(d), y, torch.from_numpy(mask))
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
    assert select_topk.launches == before

