"""Edge selection on tied distances: the port's select_edges against the JAX
package's, and a knn-only ScoreNet forward whose CA distances tie.

The JAX package breaks ties to the lower index (`lax.top_k`), so an
equal distance at the knn-th place decides both the neighbour set and the
slot order.  The port must pick the same edges in the same slots.

Tolerances: idx and edge_mask exact (selection only compares equal f32
values on both sides); ScoreNet outputs max |port - JAX| <= 1e-4 * max |JAX|
(f32 on both sides, only the summation order differs)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
from dfmdock_tpu.data.batching import pad_complex
from dfmdock_tpu.models import ScoreNet as JaxScoreNet
from dfmdock_tpu.models.edges import select_edges as jax_select_edges
from dfmdock_tpu_torch.models.edges import select_edges


def rounded_chain(n, seed):
    """CA distances of a random-walk chain rounded to multiples of 4 A: many
    rows tie at their knn-th distance."""
    rng = np.random.RandomState(seed)
    ca = np.cumsum(rng.randn(n, 3) * 2 + [3.8, 0, 0], axis=0)
    d = np.linalg.norm(ca[:, None] - ca[None, :], axis=-1)
    return (np.round(d / 4.0) * 4.0).astype(np.float32)


@pytest.mark.parametrize("sample_size", [0, 40])
@pytest.mark.parametrize("n_valid", [64, 50])
def test_select_edges_ties_match_jax(sample_size, n_valid):
    """knn 20 (+ 40 samples with JAX's own Gumbel draw injected) on the
    rounded chain: idx and edge_mask equal to JAX's in every slot."""
    n = 64
    d = rounded_chain(n, seed=3)
    mask = np.arange(n) < n_valid
    key = jax.random.PRNGKey(11)
    idx_j, em_j = jax_select_edges(key, jnp.asarray(d), jnp.asarray(mask), knn=20,
                                   sample_size=sample_size)
    gumbel = np.array(jax.random.gumbel(key, (n, n)))
    idx_p, em_p = select_edges(torch.from_numpy(d), torch.from_numpy(mask), 20, sample_size,
                               gumbel=torch.from_numpy(gumbel))
    np.testing.assert_array_equal(em_p.numpy(), np.asarray(em_j))
    np.testing.assert_array_equal(idx_p.numpy(), np.asarray(idx_j))
    # the case holds ties at the knn-th place of valid rows
    kth = np.sort(np.where(mask[None, :], d, np.inf), -1)[:n_valid, 19:21]
    assert (kth[:, 0] == kth[:, 1]).sum() > 5


def lattice_complex(seed):
    """Receptor and ligand CAs on a 4 A lattice: exact f32 distances, many
    of them equal.  The ligand's centroid is a multiple of 1/4, so centring
    in the net keeps them exact.  Non-collinear N / C offsets."""
    rng = np.random.RandomState(seed)
    grid = np.stack(np.meshgrid(np.arange(4), np.arange(4), np.arange(3),
                                indexing="ij"), -1).reshape(-1, 3)
    rec_ca = 4.0 * grid[:40]
    lig_ca = 4.0 * grid[:16] + [20.0, 4.0, 0.0]

    def backbone(ca):
        d_n = np.float32([-1.2, 0.6, 0.3]) + rng.randn(len(ca), 3) * 0.05
        d_c = np.float32([1.3, -0.4, 0.5]) + rng.randn(len(ca), 3) * 0.05
        return np.stack([ca + d_n, ca, ca + d_c], 1).astype(np.float32)

    return pad_complex(rng.randn(40, 32).astype(np.float32),
                       rng.randn(16, 32).astype(np.float32),
                       backbone(rec_ca), backbone(lig_ca), pad_to=64)


def test_score_net_knn_only_tied_distances_match_jax():
    """The eager --exact path, sample_size 0 (deterministic selection), on
    lattice CAs whose distances tie at the 20th neighbour: every output
    within 1e-4 of JAX f32."""
    jc, pc = tp.configs(sample_size=0)
    params = JaxScoreNet(jc).init(jax.random.PRNGKey(2))
    b = lattice_complex(seed=5)
    ca = b["pos"][:56, 1]
    d = np.linalg.norm(ca[:, None] - ca[None, :], axis=-1)
    kth = np.sort(d, -1)[:, 19:21]
    assert (kth[:, 0] == kth[:, 1]).sum() > 20
    out_j = JaxScoreNet(jc).apply(params, tp.jax_batch(b, 0.5), jax.random.PRNGKey(1),
                                  predict=True)
    net = tp.port_net(pc, params)
    pb = tp.port_batch(b)
    with torch.no_grad():
        out_p = net(pb, pb["pos"][None], 0.5)
    for k in ("tr_score", "rot_score", "f", "energy", "ires"):
        tp.assert_close(out_p[k][0].numpy(), out_j[k], 1e-4, k)
    assert int(out_p["num_clashes"][0]) == int(out_j["num_clashes"])
