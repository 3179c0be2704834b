"""The port's diffusion and sampler vs JAX: schedules, scores and reverse
steps with the same noise injected, and a short probability-flow (ODE)
trajectory from a shared start pose at sample_size=0."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
from dfmdock_tpu.config import R3Config as JR3Config, SamplerConfig as JSamplerConfig
from dfmdock_tpu.config import SO3Config as JSO3Config
from dfmdock_tpu.diffusion import R3Diffuser as JR3, SO3Diffuser as JSO3
from dfmdock_tpu.models import ScoreNet as JaxScoreNet
from dfmdock_tpu.sampler import EMSampler as JaxEMSampler
from dfmdock_tpu.sampler.em import modify_coords as jax_modify_coords
from dfmdock_tpu_torch.config import R3Config, SamplerConfig, SO3Config
from dfmdock_tpu_torch.diffusion import R3Diffuser, SO3Diffuser
from dfmdock_tpu_torch.diffusion.igso3 import cache_path
from dfmdock_tpu_torch.geom import axis_angle_to_matrix
from dfmdock_tpu_torch.sampler import EMSampler
from dfmdock_tpu_torch.sampler.em import modify_coords, randomize_pose

TS = [1.0, 0.7431, 0.5, 0.2, 0.05, 1e-3]


@pytest.fixture(scope="module")
def so3():
    return JSO3(JSO3Config()), SO3Diffuser(SO3Config())


def test_igso3_tables_read_the_tracked_cache(so3):
    """Same cache key -> the same committed file; tables equal."""
    j, p = so3
    assert os.path.exists(cache_path(SO3Config()))
    np.testing.assert_array_equal(p.tables.cdf, j.tables.cdf)
    np.testing.assert_array_equal(p.tables.score_scaling, j.tables.score_scaling)
    np.testing.assert_array_equal(p.discrete_sigma.numpy(), np.asarray(j.discrete_sigma))


def test_schedules_match(so3):
    """sigma / g(t) in float64 here vs float32 in JAX: rtol 1e-6; grid index exact."""
    j, p = so3
    r3j, r3p = JR3(JR3Config()), R3Diffuser(R3Config())
    for t in TS:
        np.testing.assert_allclose(p.sigma(t), float(j.sigma(jnp.float32(t))), rtol=1e-6)
        np.testing.assert_allclose(p.diffusion_coef(t),
                                   float(j.diffusion_coef(jnp.float32(t))), rtol=1e-6)
        assert p.t_to_idx(t) == int(j.t_to_idx(jnp.float32(t)))
        np.testing.assert_allclose(r3p.diffusion_coef(t),
                                   float(r3j.diffusion_coef(jnp.float32(t))), rtol=1e-6)
        tr = np.float32([[1.5, -2.0, 0.25]])
        np.testing.assert_allclose(r3p.score(torch.from_numpy(tr), t).numpy(),
                                   np.asarray(r3j.score(tr, jnp.float32(t))), rtol=1e-5)


@pytest.mark.parametrize("cached", [False, True])
def test_so3_score_matches(so3, cached):
    """IGSO3 score of axis-angle vectors: live series (f32, 1000 terms) at
    rtol 1e-4, table lookup at rtol 1e-6."""
    j, _ = so3
    conf = dataclasses.replace(SO3Config(), use_cached_score=cached)
    jconf = dataclasses.replace(JSO3Config(), use_cached_score=cached)
    j, p = JSO3(jconf), SO3Diffuser(conf)
    vec = (np.random.RandomState(0).randn(16, 3) * 0.8).astype(np.float32)
    for t in (0.9, 0.3):
        np.testing.assert_allclose(p.score(torch.from_numpy(vec), t).numpy(),
                                   np.asarray(j.score(vec, jnp.float32(t))),
                                   rtol=1e-6 if cached else 1e-4, atol=1e-5)


@pytest.mark.parametrize("ode", [False, True])
def test_reverse_steps_match(so3, ode):
    j, p = so3
    r3j, r3p = JR3(JR3Config()), R3Diffuser(R3Config())
    score = np.float32([[0.3, -1.2, 0.7]])
    key = jax.random.PRNGKey(2)
    z = torch.from_numpy(np.array(jax.random.normal(key, (1, 3))))
    for dj, dp in ((j, p), (r3j, r3p)):
        ref = dj.reverse_step(key, score, jnp.float32(0.6), jnp.float32(0.025),
                              noise_scale=0.5, ode=ode)
        out = dp.reverse_step(torch.from_numpy(score), 0.6, 0.025, 0.5, ode, z)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_modify_coords_and_random_pose():
    b = tp.padded(30, 20, seed=3)
    rot = np.float32([[[0.3, -0.2, 1.1]]])
    tr = np.float32([[[1.0, 2.0, -3.0]]])
    ref = jax_modify_coords(jnp.asarray(b["pos"]), jnp.asarray(b["lig_mask"]), rot[0], tr[0])
    out = modify_coords(torch.from_numpy(b["pos"])[None], torch.from_numpy(b["lig_mask"]),
                        torch.from_numpy(rot), torch.from_numpy(tr))
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref), atol=2e-5)
    pb = tp.port_batch(b)
    pos, tr_u, rot_u = randomize_pose(torch.Generator().manual_seed(0), pb["pos"],
                                      pb["lig_mask"], pb["node_mask"], SamplerConfig(), 4)
    assert pos.shape == (4,) + b["pos"].shape and tr_u.shape == rot_u.shape == (4, 1, 3)
    torch.testing.assert_close(pos[:, :30], pb["pos"][None, :30].expand(4, -1, -1, -1))
    # the ligand moved rigidly: internal distances kept
    d = lambda x: torch.cdist(x[..., 1, :], x[..., 1, :])
    torch.testing.assert_close(d(pos[:, 30:50]), d(pb["pos"][30:50]).expand(4, -1, -1),
                               atol=1e-3, rtol=0)


def test_ode_trajectory_matches_jax():
    """4 ODE steps from a shared start pose, knn-only edges: the final pose
    and scores within 1e-4 of max |JAX| (f32), energy the same, rotation
    updates as matrices.  The translation schedule is cut to max_sigma 1 A:
    at the default 30 A the first step at random weights throws the ligand
    ~3000 A, where one f32 ulp (2.4e-4 A) of either side already moves the
    centred coordinates and both trajectories lose their digits."""
    jc, pc = tp.configs(sample_size=0)
    params = JaxScoreNet(jc).init(jax.random.PRNGKey(0))
    b = tp.padded(40, 24, seed=9)
    scfg = dict(num_steps=4, ode=True)
    jsam = JaxEMSampler(JaxScoreNet(jc), JR3(JR3Config(max_sigma=1.0)), JSO3(JSO3Config()),
                        JSamplerConfig(**scfg))
    init_pos = b["pos"].copy()
    init_pos[40:64] += np.float32([4.0, -3.0, 2.0])
    init = (init_pos, np.float32([[4.0, -3.0, 2.0]]), np.float32([[0.2, 0.1, -0.3]]))
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    out_j = jsam.sample_one(params, jb, jax.random.PRNGKey(3),
                            init=tuple(map(jnp.asarray, init)))
    psam = EMSampler(tp.port_net(pc, params), R3Diffuser(R3Config(max_sigma=1.0)),
                     SO3Diffuser(SO3Config()), SamplerConfig(**scfg))
    out_p = psam.sample(tp.port_batch(b), 1, torch.Generator().manual_seed(0),
                        init=tuple(torch.from_numpy(x)[None] for x in init))
    moved = np.abs(np.asarray(out_j["pos"]) - init_pos).max()
    assert moved > 1e-3
    for k in ("pos", "tr_update", "tr_score", "rot_score", "energy"):
        tp.assert_close(out_p[k][0].numpy(), out_j[k], 1e-4, k)
    tp.assert_close(axis_angle_to_matrix(out_p["rot_update"][0]).numpy(),
                    axis_angle_to_matrix(torch.from_numpy(np.array(out_j["rot_update"]))).numpy(),
                    1e-4, "rot_update")
    assert int(out_p["num_clashes"][0]) == int(out_j["num_clashes"])
    assert EMSampler.rank_by_energy({"energy": torch.tensor([0.3, -1.0, 0.2])}) == 1
