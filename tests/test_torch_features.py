"""Port vs JAX on the small pieces: rotations, network blocks, 6D bins,
relpos classes and edge selection.  Same numpy-seeded inputs on both sides."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
from dfmdock_tpu.features import positional as jpos
from dfmdock_tpu.features import sixd as jsixd
from dfmdock_tpu.data.batching import pad_complex
from dfmdock_tpu.geom import rotations as jrot
from dfmdock_tpu.models import modules as jmod
from dfmdock_tpu.models.edges import select_edges as jax_select_edges
from dfmdock_tpu_torch.features import positional as ppos
from dfmdock_tpu_torch.features import sixd as psixd
from dfmdock_tpu_torch.geom import rotations as prot
from dfmdock_tpu_torch.models.edges import select_edges
from dfmdock_tpu_torch.models.modules import GraphNorm, gaussian_fourier

def T(a):
    return torch.from_numpy(np.array(a))


def _axis_angles():
    """Random vectors plus near-0 and near-pi angles."""
    rng = np.random.RandomState(0)
    v = rng.randn(64, 3).astype(np.float32)
    u = v / np.linalg.norm(v, axis=-1, keepdims=True)
    angles = np.concatenate([
        rng.uniform(0.1, 3.0, 40), [0.0, 1e-8, 1e-7, 1e-6, 1e-5, 1e-3],
        np.pi - np.array([0, 1e-7, 1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 0.1]),
        rng.uniform(3.1, 6.2, 10),
    ]).astype(np.float32)
    return (u * angles[:, None]).astype(np.float32)


@pytest.mark.parametrize("fn", ["axis_angle_to_matrix", "matrix_to_axis_angle",
                                "compose_axis_angle", "quaternion_to_matrix"])
def test_rotations_match_jax(fn):
    """f32 on both sides: 2e-6 absolute on matrices and angles (near pi the
    axis-angle of R is defined up to sign, so compare the rotations)."""
    aa = _axis_angles()
    if fn == "axis_angle_to_matrix":
        np.testing.assert_allclose(prot.axis_angle_to_matrix(T(aa)).numpy(),
                                   jrot.axis_angle_to_matrix(aa), atol=2e-6)
    elif fn == "quaternion_to_matrix":
        q = np.random.RandomState(1).randn(32, 4).astype(np.float32)
        np.testing.assert_allclose(prot.quaternion_to_matrix(T(q)).numpy(),
                                   jrot.quaternion_to_matrix(q), atol=2e-6)
    elif fn == "matrix_to_axis_angle":
        m = np.asarray(jrot.axis_angle_to_matrix(aa))
        out = prot.matrix_to_axis_angle(T(m))
        np.testing.assert_allclose(prot.axis_angle_to_matrix(out).numpy(), m, atol=2e-6)
        ref = np.asarray(jrot.matrix_to_axis_angle(m))
        not_pi = np.linalg.norm(ref, axis=-1) < np.pi - 1e-2
        np.testing.assert_allclose(out.numpy()[not_pi], ref[not_pi], atol=2e-6)
    else:
        r2 = np.roll(aa, 7, axis=0) * 0.5
        out = prot.compose_axis_angle(T(aa), T(r2))
        ref = np.asarray(jrot.compose_axis_angle(aa, r2))
        np.testing.assert_allclose(prot.axis_angle_to_matrix(out).numpy(),
                                   jrot.axis_angle_to_matrix(ref), atol=5e-6)


def test_random_rotations_are_rotations():
    r = prot.random_rotation_matrix(torch.Generator().manual_seed(0), (256,)).double()
    eye = torch.eye(3, dtype=torch.float64).expand(256, 3, 3)
    assert torch.allclose(r @ r.transpose(-1, -2), eye, atol=1e-5)
    assert torch.allclose(torch.linalg.det(r), torch.ones(256, dtype=torch.float64), atol=1e-5)


def test_blocks_match_jax():
    """layer_norm, masked graph_norm, gaussian_fourier: rtol 1e-5 (f32)."""
    rng = np.random.RandomState(2)
    x = rng.randn(3, 40, 16).astype(np.float32) * 3 + 1
    mask = np.arange(40) < 29
    g, b, ms = (rng.randn(16).astype(np.float32) for _ in range(3))
    gn = GraphNorm(16)
    with torch.no_grad():
        gn.weight.copy_(T(g)), gn.bias.copy_(T(b)), gn.mean_scale.copy_(T(ms))
        out = gn(T(x), T(mask)).numpy()
    for p in range(3):
        ref = jmod.graph_norm({"g": g, "b": b, "mean_scale": ms}, x[p], mask)
        np.testing.assert_allclose(out[p], ref, rtol=1e-5, atol=1e-5)
    ln = torch.nn.LayerNorm(16, eps=jmod.LN_EPS)
    with torch.no_grad():
        ln.weight.copy_(T(g)), ln.bias.copy_(T(b))
        np.testing.assert_allclose(ln(T(x)).numpy(),
                                   jmod.layer_norm({"g": g, "b": b}, x),
                                   rtol=1e-5, atol=1e-5)
    W = rng.randn(8).astype(np.float32)
    t = np.float32([0.001, 0.3, 1.0])
    np.testing.assert_allclose(gaussian_fourier(T(W), T(t)).numpy(),
                               jmod.gaussian_fourier({"W": W}, t), atol=2e-6)


def test_bin_boundaries_are_jax_linspace():
    for ours, (lo, hi, nb) in ((psixd.DIST_BOUNDARIES, (3.25, 50.75, 40)),
                               (psixd.ANGLE_BOUNDARIES, (-180.0, 180.0, 24)),
                               (psixd.PHI_BOUNDARIES, (0.0, 180.0, 12))):
        np.testing.assert_array_equal(np.float32(ours),
                                      np.asarray(jnp.linspace(lo, hi, nb - 1)))


def _neighbours(n, k, seed):
    rng = np.random.RandomState(seed)
    return rng.randint(0, n, size=(n, k)).astype(np.int32)


@pytest.mark.parametrize("cid", ["1AVX", "2SNI"])
def test_sixd_and_relpos_bins_match_jax(cid):
    """Bins on a DB5 complex at random neighbour sets: exact except where
    the two libraries' last-bit rounding puts a value on the other side of
    a boundary.  Ties are counted; the budget is 1e-4 of the edges and every
    tie must lie within 1e-3 (deg or A) of a boundary."""
    d = np.load(f"data/db5_npz/{cid}.npz")
    batch = pad_complex(d["rec_x"][:, :4], d["lig_x"][:, :4], d["rec_pos"], d["lig_pos"])
    n = batch["pos"].shape[0]
    idx = _neighbours(n, 60, seed=1)
    jb = jsixd.sixd_bins_at(jnp.asarray(batch["pos"]), jnp.asarray(idx))
    pb = psixd.sixd_bins_at(T(batch["pos"]), T(idx))
    dist, omega, theta, phi, _ = psixd.sixd_values_at(T(batch["pos"]), T(idx))
    fams = ((dist, psixd.DIST_BOUNDARIES), (omega, psixd.ANGLE_BOUNDARIES),
            (theta, psixd.ANGLE_BOUNDARIES), (phi, psixd.PHI_BOUNDARIES))
    ties = 0
    for (val, bounds), j, p in zip(fams, jb, pb):
        diff = np.asarray(j) != p.numpy()
        if diff.any():
            gap = np.abs(val.numpy()[diff][:, None] - np.float32(bounds)).min(-1)
            near22 = np.abs(dist.numpy()[diff] - 22.0) < 1e-3
            assert ((gap < 1e-3) | near22).all(), "bin differs away from a boundary"
        ties += int(diff.sum())
    assert ties <= 1e-4 * idx.size, f"{ties} boundary ties"
    rp_j = jpos.relpos_bin_at(jnp.asarray(batch["res_id"]),
                              jnp.asarray(batch["asym_id"]), jnp.asarray(idx))
    rp_p = ppos.relpos_bin_at(T(batch["res_id"]), T(batch["asym_id"]), T(idx))
    np.testing.assert_array_equal(np.asarray(rp_j), rp_p.numpy())
    np.testing.assert_array_equal(np.asarray(jsixd.virtual_cb(batch["pos"])),
                                  psixd.virtual_cb(T(batch["pos"])).numpy())


@pytest.mark.parametrize("n_rec,n_lig,sample", [(40, 24, 0), (40, 24, 40),
                                               (20, 12, 40), (150, 100, 40)])
def test_select_edges_matches_jax(n_rec, n_lig, sample):
    """With the Gumbel noise JAX draws injected into the port, the selected
    neighbours are identical on every valid slot and the masks are equal."""
    b = tp.padded(n_rec, n_lig, seed=n_rec)
    pos = jnp.asarray(b["pos"])
    dist = jsixd.pairwise_ca_dist(pos)
    key = jax.random.PRNGKey(n_lig)
    idx_j, mask_j = jax_select_edges(key, dist, jnp.asarray(b["node_mask"]),
                                     knn=20, sample_size=sample)
    gumbel = T(np.asarray(jax.random.gumbel(key, dist.shape)))[None]
    dist_p = T(np.array(dist))[None]  # the same distances on both sides
    idx_p, mask_p = select_edges(dist_p, T(b["node_mask"]), 20, sample,
                                 gumbel=gumbel if sample else None)
    np.testing.assert_array_equal(mask_p[0].numpy(), np.asarray(mask_j))
    valid = np.asarray(mask_j) > 0
    assert valid.sum() > 0
    np.testing.assert_array_equal(idx_p[0].numpy()[valid], np.asarray(idx_j)[valid])


def test_sampled_edges_follow_inverse_cubic():
    """The port's own Gumbel draws (torch.Generator): with one sampled slot,
    a non-kNN node is picked with probability proportional to 1/d^3 (total
    variation < 0.05 over 4000 poses, as tests/test_model.py holds JAX);
    with 40 slots the picks are distinct and never kNN members."""
    rng = np.random.RandomState(4)
    pts = rng.randn(30, 3) * 8
    dist = np.linalg.norm(pts[:, None] - pts[None, :], axis=-1).astype(np.float32)
    mask = torch.ones(30, dtype=torch.bool)
    true_knn = np.argsort(dist[0])[:20]
    probs = 1.0 / np.maximum(dist[0], 1e-10) ** 3
    probs[true_knn] = 0
    probs /= probs.sum()
    draws = 4000
    d = T(dist).expand(draws, 30, 30)
    gen = torch.Generator().manual_seed(2)
    idx, _ = select_edges(d, mask, knn=20, sample_size=1, generator=gen)
    emp = np.bincount(idx[:, 0, 20].numpy(), minlength=30) / draws
    assert np.abs(emp - probs).sum() / 2 < 0.05

    big = np.cumsum(rng.randn(200, 3) * 2 + [3.8, 0, 0], axis=0)
    dist = np.linalg.norm(big[:, None] - big[None, :], axis=-1).astype(np.float32)
    idx, emask = select_edges(T(dist)[None], torch.ones(200, dtype=torch.bool),
                              generator=torch.Generator().manual_seed(3))
    assert (emask[0].sum(-1) == 60).all()
    for i in range(0, 200, 17):
        row = idx[0, i].tolist()
        assert len(set(row)) == 60
        assert set(row[:20]) == set(np.argsort(dist[i])[:20].tolist())
