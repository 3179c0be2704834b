"""The port's sampler draws against the JAX package's (ROADMAP F4), on the CPU.

Each of the three random draws of a docking run, from many draws on each
side: the start pose (`sampler/em.randomize_pose` against
`dfmdock_tpu/sampler/em.randomize_pose`), each step's SDE noise as the
update it makes (the port's EMSampler with zero scores, its diffusers'
updates recorded, against JAX's `reverse_step` from the keys
`EMSampler.sample_one` splits), and the edges `select_edges` samples for
fixed distances (inclusion frequencies per candidate, port against JAX's
`select_edges`).  The continuous draws go through two-sample
Kolmogorov-Smirnov tests, the edges through a chi-square test of equal
inclusion frequencies; each family holds at ALPHA = 1e-3, split over its
tests (Bonferroni).  The draws are seeded, so every run passes or fails
alike; each family must also reject a draw that is off by a known amount
(a translation 20% wider, SDE noise 15% larger, edges drawn by 1/d^2), so
a pass says the test could have seen a difference of that size.

Then scripts/export_jax_draws.py: the draws it saves, injected into the
port's sampler (`place_pose`, `sample(noise=)`) with zero scores, give JAX's
EMSampler the same poses, and the committed file is what the script writes.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

import _torch_parity as tp
from dfmdock_tpu.config import R3Config as JR3Config, SamplerConfig as JSamplerConfig
from dfmdock_tpu.config import SO3Config as JSO3Config
from dfmdock_tpu.diffusion import R3Diffuser as JR3, SO3Diffuser as JSO3
from dfmdock_tpu.models.edges import select_edges as jax_select_edges
from dfmdock_tpu.sampler import EMSampler as JaxEMSampler
from dfmdock_tpu.sampler.em import randomize_pose as jax_randomize_pose
from dfmdock_tpu_torch.config import R3Config, SamplerConfig, SO3Config
from dfmdock_tpu_torch.diffusion import R3Diffuser, SO3Diffuser
from dfmdock_tpu_torch.features.sixd import pairwise_ca_dist
from dfmdock_tpu_torch.geom import axis_angle_to_matrix
from dfmdock_tpu_torch.models.edges import sample_gumbel, select_edges
from dfmdock_tpu_torch.ops.select_topk import select_topk
from dfmdock_tpu_torch.sampler import EMSampler
from dfmdock_tpu_torch.sampler.em import place_pose, randomize_pose

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "scripts"))
import export_jax_draws as export  # noqa: E402

ALPHA = 1e-3
POSES = 10000
KNN, SAMPLE = 20, 40


def ks_pvalues(a, b):
    """Two-sample KS p-values of each column of a and b [draws, k]."""
    return np.array([stats.ks_2samp(a[:, i], b[:, i]).pvalue for i in range(a.shape[1])])


def complex_batch():
    b = tp.padded(60, 50, seed=4)
    return b, {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def start_draws():
    """(port, JAX): POSES start poses' translation [P, 3] and rotation
    matrix entries [P, 9]; and the port's with its translation 20% wider."""
    b, pb = complex_batch()
    args = (pb["pos"], pb["lig_mask"], pb["node_mask"], SamplerConfig())
    _, tr, rot = randomize_pose(torch.Generator().manual_seed(0), *args, POSES)
    g = torch.Generator().manual_seed(1)
    quat, noise = torch.randn((POSES, 4), generator=g), torch.randn((POSES, 1, 3), generator=g)
    _, tr_wide, _ = place_pose(*args, quat, noise * 1.2)
    keys = jax.random.split(jax.random.PRNGKey(0), POSES)
    _, tr_j, rot_j = jax.vmap(lambda k: jax_randomize_pose(
        k, jnp.asarray(b["pos"]), jnp.asarray(b["lig_mask"]), jnp.asarray(b["node_mask"]),
        JSamplerConfig()))(keys)
    mats = lambda aa: axis_angle_to_matrix(torch.from_numpy(np.array(aa)).reshape(-1, 3))
    return ((tr.reshape(-1, 3).numpy(), mats(rot).reshape(-1, 9).numpy()),
            (np.asarray(tr_j).reshape(-1, 3), mats(rot_j).reshape(-1, 9).numpy()),
            tr_wide.reshape(-1, 3).numpy())


def test_start_pose_distribution():
    """The translation's three components and the rotation matrix's nine
    entries (Haar-uniform: each entry uniform on [-1, 1]), 12 KS tests."""
    (tr_p, rot_p), (tr_j, rot_j), tr_wide = start_draws()
    p = np.concatenate([ks_pvalues(tr_p, tr_j), ks_pvalues(rot_p, rot_j)])
    assert p.min() > ALPHA / len(p), p
    assert np.abs(rot_p).max() <= 1.0 + 1e-6
    assert ks_pvalues(tr_wide, tr_j).min() < ALPHA / len(p)


class ZeroNet:
    """A score network that returns zero scores: each step's update is then
    the SDE noise alone."""

    def prepare(self, batch, static):
        return {**batch, "h0": batch["x"]}

    def __call__(self, batch, pos, t, generator=None, scores_only=False):
        z = torch.zeros(pos.shape[0], 1, 3)
        out = {"tr_score": z, "rot_score": z}
        if not scores_only:
            out.update(energy=torch.zeros(pos.shape[0]),
                       num_clashes=torch.zeros(pos.shape[0], dtype=torch.int32))
        return out


class Recording:
    """A diffuser whose reverse steps' updates are recorded."""

    def __init__(self, diffuser):
        self.diffuser, self.updates = diffuser, []

    def reverse_step(self, *args, **kwargs):
        update = self.diffuser.reverse_step(*args, **kwargs)
        self.updates.append(update)
        return update


STEPS_TESTED = (0, 13, 26, 38)


def noise_updates(poses=8000, steps=40):
    """(port, JAX): {step: [poses, 6] rotation and translation updates} of a
    zero-score sampler, at STEPS_TESTED and the last step."""
    _, pb = complex_batch()
    cfg = SamplerConfig(num_steps=steps)
    r3, so3 = Recording(R3Diffuser(R3Config())), Recording(SO3Diffuser(SO3Config()))
    EMSampler(ZeroNet(), r3, so3, cfg).sample(pb, poses, torch.Generator().manual_seed(2))
    port = {s: torch.cat([so3.updates[s], r3.updates[s]], -1).reshape(poses, 6).numpy()
            for s in STEPS_TESTED + (steps - 1,)}
    jr3, jso3 = JR3(JR3Config()), JSO3(JSO3Config())
    jcfg = JSamplerConfig(num_steps=steps)
    ts, dt, tr_ns, rot_ns = JaxEMSampler(None, jr3, jso3, jcfg)._schedule()

    def pose(key):
        _, k_loop = jax.random.split(key)
        step_keys = jax.random.split(k_loop, steps)
        out = []
        for s in STEPS_TESTED + (steps - 1,):
            _, k_rot, k_tr = jax.random.split(step_keys[s], 3)
            zero = jnp.zeros((1, 3))
            out.append(jnp.concatenate([
                jso3.reverse_step(k_rot, zero, ts[s], dt, noise_scale=rot_ns[s]),
                jr3.reverse_step(k_tr, zero, ts[s], dt, noise_scale=tr_ns[s])], -1))
        return jnp.stack(out)

    upd = np.asarray(jax.vmap(pose)(jax.random.split(jax.random.PRNGKey(2), poses)))
    return port, {s: upd[:, i].reshape(poses, 6)
                  for i, s in enumerate(STEPS_TESTED + (steps - 1,))}


def pooled(u):
    """[poses, 6] updates -> [3 poses, 2]: the rotation's and the
    translation's three components (independent, alike) pooled."""
    return np.stack([u[:, :3].reshape(-1), u[:, 3:].reshape(-1)], -1)


def test_sde_noise_distribution():
    """Each tested step's rotation and translation updates, the three
    components of each pooled (2 x 4 KS tests), the schedule's noise scale
    and diffusion coefficient included; the last step's are 0 on both
    sides; the port's updates 15% larger are rejected."""
    port, jax_upd = noise_updates()
    p = np.concatenate([ks_pvalues(pooled(port[s]), pooled(jax_upd[s])) for s in STEPS_TESTED])
    assert p.min() > ALPHA / len(p), p
    assert not np.any(port[39]) and not np.any(jax_upd[39])
    wide = np.concatenate([ks_pvalues(pooled(1.15 * port[s]), pooled(jax_upd[s]))
                           for s in STEPS_TESTED])
    assert wide.min() < ALPHA / len(p), wide


def inclusion_counts(idx, edge_mask, n):
    """[N, N] counts of column j among row i's sampled (non-kNN) slots over
    the leading draw axis."""
    idx, valid = idx[..., KNN:].reshape(-1, idx.shape[-2], SAMPLE), edge_mask[..., KNN:] > 0.5
    counts = np.zeros((n, n))
    rows = np.broadcast_to(np.arange(n)[None, :, None], idx.shape)
    np.add.at(counts, (rows[valid.reshape(idx.shape)], idx[valid.reshape(idx.shape)]), 1)
    return counts


def equal_frequencies_pvalue(a, b, draws):
    """Chi-square test that two [N, N] inclusion counts over `draws` draws
    each come from the same inclusion probabilities: per cell (c_a - c_b)^2
    / ((c_a + c_b)(1 - p)), p = (c_a + c_b) / (2 draws), summed over the
    cells with at least 10 inclusions on the two sides together; one degree
    of freedom per cell less one per row (a row's inclusions per draw are
    fixed)."""
    tot = a + b
    keep = (tot >= 10) & (tot < 2 * draws)
    p = tot / (2 * draws)
    x = ((a - b) ** 2 / np.where(keep, tot * (1 - p), 1.0))[keep].sum()
    df = int(keep.sum()) - int(keep.any(1).sum())
    return stats.chi2.sf(x, df)


def test_sampled_edges_frequencies():
    """Inclusion frequency of every (row, candidate) beyond the kNN over 400
    draws on each side, for the distances of one padded complex (110 valid
    nodes, so 90 candidates a row for 40 slots); the port's selection with
    1/d^2 in place of 1/d^3 is rejected."""
    draws = 400
    _, pb = complex_batch()
    dist = pairwise_ca_dist(pb["pos"][None])[0]
    n = dist.shape[-1]
    d = dist.expand(draws, n, n).contiguous()
    idx_p, em_p = select_edges(d, pb["node_mask"], KNN, SAMPLE,
                               generator=torch.Generator().manual_seed(3))
    gumbel = sample_gumbel(d.shape, torch.Generator().manual_seed(4), "cpu")
    y2 = torch.where(pb["node_mask"][None, :], -2.0 * torch.log(torch.clamp(d, min=1e-10)),
                     torch.full_like(d, -1e30)) + gumbel
    idx_2, em_2 = select_topk(d, y2, pb["node_mask"], KNN, SAMPLE)
    keys = jax.random.split(jax.random.PRNGKey(3), draws)
    idx_j, em_j = jax.vmap(lambda k: jax_select_edges(
        k, jnp.asarray(dist.numpy()), jnp.asarray(pb["node_mask"].numpy()), KNN, SAMPLE))(keys)
    c_p = inclusion_counts(idx_p.numpy(), em_p.numpy(), n)
    c_j = inclusion_counts(np.asarray(idx_j), np.asarray(em_j), n)
    assert c_p.sum() == c_j.sum() == draws * int(pb["node_mask"].sum()) * SAMPLE
    assert equal_frequencies_pvalue(c_p, c_j, draws) > ALPHA
    c_2 = inclusion_counts(idx_2.numpy(), em_2.numpy(), n)
    assert equal_frequencies_pvalue(c_2, c_j, draws) < ALPHA


class JaxZeroNet:
    def apply(self, params, batch, key, predict=True, scores_only=False):
        z = jnp.zeros((1, 3))
        out = {"tr_score": z, "rot_score": z}
        if not scores_only:
            out.update(energy=jnp.float32(0.0), num_clashes=jnp.int32(0))
        return out


def test_exported_draws_are_the_jax_samplers():
    """export_jax_draws.sample_draws(key) injected into the port's sampler
    (start poses through place_pose, the SDE noise through sample(noise=))
    with zero scores gives JAX's EMSampler.sample(key) with zero scores:
    poses within 1e-4 A (float32 sums in another order), the accumulated
    updates within 1e-5."""
    poses, steps = 3, 6
    b, pb = complex_batch()
    key = jax.random.PRNGKey(11)
    jcfg = JSamplerConfig(num_steps=steps)
    jr = JaxEMSampler(JaxZeroNet(), JR3(JR3Config()), JSO3(JSO3Config()), jcfg).sample(
        None, {k: jnp.asarray(v) for k, v in b.items()}, key, poses)
    d = export.sample_draws(key, poses, steps)
    cfg = SamplerConfig(num_steps=steps)
    t = lambda x: torch.from_numpy(x)
    init = place_pose(pb["pos"], pb["lig_mask"], pb["node_mask"], cfg, t(d["quat"]), t(d["tr"]))
    pr = EMSampler(ZeroNet(), R3Diffuser(R3Config()), SO3Diffuser(SO3Config()), cfg).sample(
        pb, poses, None, init=init, noise=(t(d["z_rot"]), t(d["z_tr"])))
    np.testing.assert_allclose(pr["pos"].numpy(), np.asarray(jr["pos"]), rtol=0, atol=1e-4)
    for k in ("tr_update", "rot_update"):
        np.testing.assert_allclose(pr[k].numpy(), np.asarray(jr[k]), rtol=0, atol=1e-5)


def test_committed_draws_file():
    """The committed npz is what the script writes for its seeds (5-30), and
    holds the record's 4 complexes x 40 poses x 40 steps per seed."""
    if not os.path.exists(export.OUT):
        pytest.fail(f"{export.OUT} is missing: run scripts/export_jax_draws.py")
    saved = np.load(export.OUT)
    want = export.record_draws(export.SEEDS)
    assert sorted(saved.files) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(saved[k], v, err_msg=k)
    assert saved["s5/1AVX/z_rot"].shape == (40, 40, 1, 3)
