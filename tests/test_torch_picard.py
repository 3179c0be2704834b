"""The port's Picard latency mode (sampler/picard.py): T = 6 iterations reach
the port's sequential ODE with the same generator (edge noise included),
fewer iterations come closer with each one, and each iteration count gives
the JAX PicardSampler's pose from a shared start (knn-only edges, f32).

The translation schedule is cut to max_sigma 1 A, as in
test_torch_sampler.py: at random weights the default 30 A throws the ligand
~3000 A, where one f32 ulp already moves the centred coordinates."""
import dataclasses

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
from dfmdock_tpu.sampler import PicardSampler as JaxPicard
from dfmdock_tpu_torch.config import R3Config, SamplerConfig, SO3Config
from dfmdock_tpu_torch.diffusion import R3Diffuser, SO3Diffuser
from dfmdock_tpu_torch.models import DFMDockModel, ScoreNet
from dfmdock_tpu_torch.sampler import EMSampler, PicardSampler

T = 6
SCFG = dict(num_steps=T, ode=True, init_tr_sigma=4.0)


def _samplers(net, num_iters):
    r3, so3 = R3Diffuser(R3Config(max_sigma=1.0)), SO3Diffuser(SO3Config())
    cfg = SamplerConfig(**SCFG)
    return EMSampler(net, r3, so3, cfg), PicardSampler(net, r3, so3, cfg, num_iters)


@pytest.mark.parametrize("model", [ScoreNet, DFMDockModel])
def test_converges_to_sequential_ode(model):
    """T iterations against EMSampler.sample under the same generator seed:
    random start, 20 + 40 sampled edges a step (the Picard sampler draws
    each step's noise once, in the sequential order), two poses; the final
    pose, updates, energy and every step's pose within 1e-4 of their
    scale."""
    _, pc = tp.configs(sample_size=40)
    pc = dataclasses.replace(pc, knn=8)
    net = model(pc).init_weights(torch.Generator().manual_seed(1)).eval()
    pb = tp.port_batch(tp.padded(50, 30, seed=7))
    em, pic = _samplers(net, T)
    a = em.sample(pb, 2, torch.Generator().manual_seed(3), record_trajectory=True)
    b = pic.sample(pb, 2, torch.Generator().manual_seed(3), record_trajectory=True)
    assert float((a["pos"] - pb["pos"]).abs().max()) > 1e-2
    assert b["trajectory"].shape == (2, T) + tuple(pb["pos"].shape)
    assert torch.equal(b["trajectory"][:, -1], b["pos"])
    for k in ("pos", "tr_update", "rot_update", "energy", "tr_score", "rot_score",
              "trajectory"):
        tp.assert_close(b[k].numpy(), a[k].numpy(), 1e-4, k)
    assert torch.equal(a["num_clashes"], b["num_clashes"])


def test_partial_iterations_improve():
    """The final pose's error against the sequential ODE shrinks with the
    iteration count, and is 0 to f32 rounding at K = T."""
    _, pc = tp.configs(sample_size=0)
    net = ScoreNet(pc).init_weights(torch.Generator().manual_seed(2)).eval()
    pb = tp.port_batch(tp.padded(40, 24, seed=32))
    em, _ = _samplers(net, 1)
    ref = em.sample(pb, 1, torch.Generator().manual_seed(9))["pos"]
    errs = []
    for k in (1, 3, T):
        _, pic = _samplers(net, k)
        got = pic.sample(pb, 1, torch.Generator().manual_seed(9))["pos"]
        errs.append(float((got - ref).abs().max()))
    assert errs[2] <= errs[1] <= errs[0] + 1e-6, errs
    assert errs[0] > 1e-3 and errs[2] < 1e-3, errs


@pytest.mark.parametrize("num_iters", [2, T])
def test_matches_jax_picard(num_iters):
    """The port's PicardSampler against JAX's from a shared start pose,
    knn-only edges: the final pose, updates and scores within 1e-4 of max
    |JAX| at a partial and at the full iteration count."""
    jc, pc = tp.configs(sample_size=0)
    params = JaxScoreNet(jc).init(jax.random.PRNGKey(0))
    b = tp.padded(40, 24, seed=9)
    init_pos = b["pos"].copy()
    init_pos[40:64] += np.float32([4.0, -3.0, 2.0])
    init = (init_pos, np.float32([[4.0, -3.0, 2.0]]), np.float32([[0.2, 0.1, -0.3]]))
    jsam = JaxPicard(JaxScoreNet(jc), JR3(JR3Config(max_sigma=1.0)), JSO3(JSO3Config()),
                     JSamplerConfig(**SCFG), num_iters=num_iters)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    out_j = jax.jit(lambda: jsam.sample_one(params, jb, jax.random.PRNGKey(3),
                                            init=tuple(map(jnp.asarray, init))))()
    _, pic = _samplers(tp.port_net(pc, params), num_iters)
    out_p = pic.sample(tp.port_batch(b), 1, torch.Generator().manual_seed(0),
                       init=tuple(torch.from_numpy(x)[None] for x in init))
    assert np.abs(np.asarray(out_j["pos"]) - init_pos).max() > 1e-3
    for k in ("pos", "tr_update", "rot_update", "tr_score", "rot_score", "energy"):
        tp.assert_close(out_p[k][0].numpy(), out_j[k], 1e-4, k)
    assert int(out_p["num_clashes"][0]) == int(out_j["num_clashes"])


def test_refuses_what_jax_refuses():
    net = ScoreNet(tp.configs()[1])
    r3, so3 = R3Diffuser(R3Config()), SO3Diffuser(SO3Config())
    for cfg in (SamplerConfig(ode=False), SamplerConfig(ode=True, use_clash_force=True),
                SamplerConfig(ode=True, integrator="heun")):
        with pytest.raises(ValueError):
            PicardSampler(net, r3, so3, cfg)
