"""A 40-step probability-flow (ODE) trajectory with the trained weights of
each lineage (mlsb: ckpts/db5_demo/weights.npz; DFMDock:
ckpts/db5_holdout_dfmdock/weights.npz) on DB5 1QA9, the port against the JAX
package's f32 sampler from a shared start pose, knn-only edges (sample_size
0), the default schedules.  With trained weights no cut of the translation
schedule's max_sigma is needed (test_torch_sampler.py cuts it to 1 A at
random weights, whose first step throws the ligand ~3000 A; here the ligand
moves at most ~25 A).

Free-running, the two trajectories agree to f32 rounding until a state in
which a discrete feature lies within their difference of its threshold: a
row's 20th and 21st neighbours (mlsb, on this start: the state before step
8, 2.3e-5 A apart, the trajectories 2.8e-4 A) or an edge's 6D bin boundary
(DFMDock: step 18).  There the edges or bins may differ and the poses
part, as any two f32 implementations would.  So the free run is held to
1e-4 of max |JAX| over its first FREE_STEPS steps, and every one of the 40
steps teacher-forced: the port's step from JAX's state s lands within 1e-4
of max |JAX| on JAX's state s + 1 (measured: ~4e-6 A on every step of both
lineages); the final full forward at JAX's last pose likewise.

The sweep's reverse SDE with the DFMDock weights (sampled edges, a padded
batch) is held the same way, teacher-forced with JAX's noise."""
import dataclasses

import jax
import pytest
import jax.numpy as jnp
import numpy as np
import torch

import _torch_parity as tp
from dfmdock_tpu.config import R3Config as JR3Config, SamplerConfig as JSamplerConfig
from dfmdock_tpu.config import SO3Config as JSO3Config
from dfmdock_tpu.config import from_yaml as jax_from_yaml
from dfmdock_tpu.data.dataset import complex_to_batch
from dfmdock_tpu.diffusion import R3Diffuser as JR3, SO3Diffuser as JSO3
from dfmdock_tpu.models import ScoreNet as JaxScoreNet
from dfmdock_tpu.models.dfmdock import DFMDockModel as JaxDFMDock
from dfmdock_tpu.sampler import EMSampler as JaxEMSampler
from dfmdock_tpu.sampler.em import randomize_pose as jax_randomize_pose
from dfmdock_tpu_torch.cli.common import load_model
from dfmdock_tpu_torch.config import DFMDockConfig, ModelConfig, R3Config, SamplerConfig
from dfmdock_tpu_torch.config import SO3Config
from dfmdock_tpu_torch.data.convert import load_npz_complex
from dfmdock_tpu_torch.diffusion import R3Diffuser, SO3Diffuser
from dfmdock_tpu_torch.geom import axis_angle_to_matrix
from dfmdock_tpu_torch.sampler import EMSampler
from dfmdock_tpu_torch.sampler.em import modify_coords, step_schedule

FREE_STEPS = 5
LINEAGES = {"mlsb": ("ckpts/db5_demo", JaxScoreNet),
            "dfmdock": ("ckpts/db5_holdout_dfmdock", JaxDFMDock)}


@pytest.mark.parametrize("lineage", sorted(LINEAGES))
def test_trained_40_step_ode_matches_jax(lineage):
    ckpt, jax_model = LINEAGES[lineage]
    jcfg = jax_from_yaml(f"{ckpt}/config.yaml")
    jmodel = dataclasses.replace(jcfg.model, sample_size=0)
    with np.load(f"{ckpt}/weights.npz") as z:
        flat = {k: z[k] for k in z.files}
    params = _unflatten(flat)
    raw = load_npz_complex("data/db5_npz/1QA9.npz")
    b = complex_to_batch(raw)
    lig = b["lig_mask"] > 0
    # a shared start: the native ligand turned and moved off its site
    rot = np.float32([[0.4, -0.3, 0.5]])
    R = np.asarray(axis_angle_to_matrix(torch.from_numpy(rot))[0])
    c = b["pos"][lig].reshape(-1, 3).mean(0)
    shift = np.float32([8.0, -6.0, 5.0])
    init_pos = b["pos"].copy()
    init_pos[lig] = (b["pos"][lig] - c) @ R.T + c + shift
    init = (init_pos, shift[None], rot)

    scfg = dict(num_steps=40, ode=True)
    jsam = JaxEMSampler(jax_model(jmodel), JR3(JR3Config()), JSO3(JSO3Config()),
                        JSamplerConfig(**scfg))
    jb = {k: jnp.asarray(v) for k, v in b.items() if k not in ("n_rec", "n_lig")}
    out_j = jax.jit(lambda: jsam.sample_one(params, jb, jax.random.PRNGKey(3),
                                            init=tuple(map(jnp.asarray, init)),
                                            record_trajectory=True))()
    traj_j = np.array(out_j["trajectory"])
    moved = np.abs(traj_j[-1] - init_pos).max()
    assert 1.0 < moved < 200.0, moved  # docked, not thrown
    scale = np.abs(traj_j).max()

    cfg = DFMDockConfig(model=ModelConfig(**dataclasses.asdict(jmodel)),
                        sampler=SamplerConfig(**scfg))
    net = load_model(f"{ckpt}/weights.npz", cfg, torch.device("cpu"), lineage=lineage)
    psam = EMSampler(net, R3Diffuser(R3Config()), SO3Diffuser(SO3Config()), cfg.sampler)
    pb = tp.port_batch(b)
    out_p = psam.sample(pb, 1, torch.Generator().manual_seed(0),
                        init=tuple(torch.from_numpy(x)[None] for x in init),
                        record_trajectory=True)
    traj_p = out_p["trajectory"][0].numpy()

    # free run: its first steps, before any discrete threshold is near
    diff = np.abs(traj_p - traj_j).max((1, 2, 3))
    assert diff[:FREE_STEPS].max() <= 1e-4 * scale, diff[:FREE_STEPS]

    # teacher-forced: the port's step from every JAX state
    states = np.concatenate([init_pos[None], traj_j])
    ts, dt, _, _ = step_schedule(psam.cfg)
    with torch.no_grad():
        for s, t in enumerate(ts):
            x = torch.from_numpy(states[s])[None]
            out = net(pb, x, t, scores_only=True)
            rot = psam.so3.reverse_step(out["rot_score"], t, dt, ode=True)
            tr = psam.r3.reverse_step(out["tr_score"], t, dt, ode=True)
            nxt = modify_coords(x, pb["lig_mask"], rot, tr)
            tp.assert_close(nxt[0].numpy(), traj_j[s], 1e-4 * scale / np.abs(traj_j[s]).max(),
                            f"step {s}")
        final = net(pb, torch.from_numpy(traj_j[-1])[None], ts[-1])
    for k in ("tr_score", "rot_score", "energy"):
        tp.assert_close(final[k][0].numpy(), out_j[k], 1e-4, k)
    assert int(final["num_clashes"][0]) == int(out_j["num_clashes"])


def test_trained_dfmdock_sde_steps_match_jax():
    """The sweep's reverse SDE with the trained DFMDock weights: 1QA9 padded
    to the sweep's bucket (256), 40 sampled edges a step, 10 steps from the
    JAX sampler's random start.  JAX's noise (each step's Gumbel keys, as
    EGNNNet draws them, and its rotation and translation normals) goes into
    the port, whose step from every JAX state lands within 1e-4 of max
    |JAX| on JAX's next state."""
    ckpt = LINEAGES["dfmdock"][0]
    jcfg = jax_from_yaml(f"{ckpt}/config.yaml")
    with np.load(f"{ckpt}/weights.npz") as z:
        params = _unflatten({k: z[k] for k in z.files})
    b = complex_to_batch(load_npz_complex("data/db5_npz/1QA9.npz"), pad_to=256)
    scfg = dict(num_steps=10)
    jsam = JaxEMSampler(JaxDFMDock(jcfg.model), JR3(JR3Config()), JSO3(JSO3Config()),
                        JSamplerConfig(**scfg))
    jb = {k: jnp.asarray(v) for k, v in b.items() if k not in ("n_rec", "n_lig")}
    key = jax.random.PRNGKey(5)
    out_j = jax.jit(lambda: jsam.sample_one(params, jb, key, record_trajectory=True))()
    k_init, k_loop = jax.random.split(key)
    pos0, _, _ = jax_randomize_pose(k_init, jb["pos"], jb["lig_mask"], jb["node_mask"],
                                    jsam.cfg)
    states = np.concatenate([np.asarray(pos0)[None], np.array(out_j["trajectory"])])
    scale = np.abs(states).max()

    cfg = DFMDockConfig(model=ModelConfig(**dataclasses.asdict(jcfg.model)),
                        sampler=SamplerConfig(**scfg))
    net = load_model(f"{ckpt}/weights.npz", cfg, torch.device("cpu"), lineage="dfmdock")
    psam = EMSampler(net, R3Diffuser(R3Config()), SO3Diffuser(SO3Config()), cfg.sampler)
    pb = tp.port_batch(b)
    ts, dt, tr_ns, rot_ns = step_schedule(cfg.sampler)
    normal = lambda k: torch.from_numpy(np.array(jax.random.normal(k, (1, 3))))[None]
    with torch.no_grad():
        for s, (t, k) in enumerate(zip(ts, jax.random.split(k_loop, len(ts)))):
            k_net, k_rot, k_tr = jax.random.split(k, 3)
            gumbel = jax.random.gumbel(jax.random.split(k_net)[0], (256, 256))
            x = torch.from_numpy(states[s])[None]
            out = net(pb, x, t, gumbel=torch.from_numpy(np.array(gumbel))[None],
                      scores_only=True)
            rot = psam.so3.reverse_step(out["rot_score"], t, dt, rot_ns[s], False, normal(k_rot))
            tr = psam.r3.reverse_step(out["tr_score"], t, dt, tr_ns[s], False, normal(k_tr))
            nxt = modify_coords(x, pb["lig_mask"], rot, tr)
            tp.assert_close(nxt[0].numpy(), states[s + 1],
                            1e-4 * scale / np.abs(states[s + 1]).max(), f"step {s}")
    assert np.abs(states[-1] - states[0]).max() > 1.0


def _unflatten(flat: dict):
    """{"a/0/w": array} -> the JAX pytree (lists where the keys are indices)."""
    tree = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(tree)
