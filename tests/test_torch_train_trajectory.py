"""A training trajectory of each lineage: the port against the JAX package,
step after step, on the CPU.

The single-step tests (test_torch_losses.py, test_torch_train.py) hold one
loss with its gradients, one training forward, and two AdamW updates on
random gradients.  Here the whole composition runs for STEPS optimizer
steps on both sides from the same weights: the loss, its gradient (second
order through dedx, --grad-energy), AdamW's moments and bias corrections,
then the next step's loss on the updated weights, alternating over two
small padded complexes.  Each lineage trains at its checkpoint's protocol:
mlsb as ckpts/db5_demo (--grad-energy --use-contrastive-loss), the DFMDock
lineage as ckpts/db5_holdout_dfmdock (--grad-energy); lr 1e-4, no weight
decay, as both.

Both sides take the same draws, made from one numpy seed: each step's t,
translation and rotation perturbations with their scores and score
scalings (the JAX diffusers' formulas on numpy normals and uniforms,
injected through `draw_perturbation`'s `injected`); the contrastive
negatives come from each step's JAX key and are injected into the port, as
in test_torch_losses.py.  No random rotation, dropout 0, kNN-only edges
(sample_size 0).  The JAX side is jax.value_and_grad of its loss (eager:
its f32 arithmetic is the port's up to summation order) with its exact
gather (test_torch_losses.py says why), then optax through its
make_optimizer; the port's is its loss, .backward(), then its
make_optimizer's AdamW.

Tolerances, and why.  The two sides sum in other orders, so each gradient
carries f32 rounding noise, which the trajectory then carries forward:
- Loss terms, every step: within LOSS_REL of JAX's (+1e-6).  The first
  step's terms come from equal weights (test_torch_losses holds them to
  1e-4); later ones from weights that differ as below.
- Weights after step k: AdamW moves an element by lr * m_hat / (sqrt(v_hat)
  + eps), a ratio of its gradient's moving averages, so an element's update
  error is its gradient's relative error, not its absolute one.  The bulk
  of the elements lie within BULK_REL * lr * k of JAX's (lr * k bounds how
  far either side has moved; the f32 rounding of the weight itself is
  added).  An element whose gradient is at the noise level (near zero, of
  either sign) takes a sign-like update of up to lr on each side, so it may
  differ by up to 2 * lr a step: at most TAIL_FRAC of all elements may
  exceed the bulk bound, and none 2 * ADAM_MAX * lr * k, the most two AdamW
  trajectories can part in k steps (|m_hat / sqrt(v_hat)| <= ADAM_MAX for
  beta1 = 0.9, beta2 = 0.999).
- t_embed.W is frozen on both sides: bit-equal to its start.
Step counts: the DFMDock lineage runs 20 steps, mlsb 10.  At random
initialisation the mlsb trajectory is chaotic in f32: the port's own f32
trajectory and its float64 one (same code, same draws) part from ~12 steps
on (loss terms 6.5e-2 apart at step 12, a third of the weights beyond the
bulk bound by step 20), so no bound that holds the bulk holds beyond that;
the DFMDock lineage's stays within 4e-6 (loss terms) of its float64 one
over 20 steps.  Measured here: the port against JAX, DFMDock loss terms
within 2.5e-5 and mlsb within 1.6e-4 over their steps, at most 0.24% of
the elements beyond the bulk bound (at the first step), none beyond
1.9 * lr * k.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parity import configs, jax_batch, jax_flat, padded, port_batch
from dfmdock_tpu.config import ExperimentConfig as JaxExperimentConfig
from dfmdock_tpu.config import R3Config as JaxR3Config
from dfmdock_tpu.config import SO3Config as JaxSO3Config
from dfmdock_tpu.diffusion import R3Diffuser as JaxR3
from dfmdock_tpu.diffusion import SO3Diffuser as JaxSO3
from dfmdock_tpu.models import ScoreNet as JaxScoreNet
from dfmdock_tpu.models.egnn_net import EGNNNet as JaxEGNNNet
from dfmdock_tpu.train.dfmdock_losses import dfmdock_loss_fn as jax_dfmdock_loss
from dfmdock_tpu.train.losses import loss_fn as jax_loss
from dfmdock_tpu.train.trainer import make_optimizer as jax_make_optimizer
from dfmdock_tpu_torch.config import ExperimentConfig, R3Config, SO3Config
from dfmdock_tpu_torch.diffusion import R3Diffuser, SO3Diffuser
from dfmdock_tpu_torch.models import EGNNNet, ScoreNet
from dfmdock_tpu_torch.params import to_state_dict
from dfmdock_tpu_torch.train.dfmdock_losses import dfmdock_loss_fn
from dfmdock_tpu_torch.train.losses import _EPS_T, loss_fn
from dfmdock_tpu_torch.train.trainer import make_optimizer
from test_torch_losses import jax_contrastive_draws

STEPS = {"mlsb": 10, "dfmdock": 20}
PAD = 128  # both complexes padded alike: one compiled JAX step
LOSS_REL = 1e-3
BULK_REL = 1e-3
TAIL_FRAC = 1e-2
ADAM_MAX = 0.1 / np.sqrt(1e-3)  # (1 - beta1) / sqrt(1 - beta2)
PROTOCOLS = {
    "mlsb": dict(grad_energy=True, use_contrastive_loss=True),
    "dfmdock": dict(grad_energy=True),
}


@pytest.fixture(autouse=True)
def exact_gather(monkeypatch):
    """The f32 reference's gather: src[idx], with an exact backward."""
    import dfmdock_tpu.ops.gather as gather

    monkeypatch.setattr(gather, "gather_rows", lambda src, idx: jnp.take(src, idx, axis=0))


def draws(rng, r3, so3):
    """One step's perturbation from the numpy `rng`: t ~ U(eps, 1), the
    translation sigma(t) z and an IGSO3(t) rotation (uniform axis, angle by
    the inverse CDF), each with its score and score scaling."""
    t = np.float32(_EPS_T + rng.rand() * (1.0 - _EPS_T))
    tr = np.float32(r3.sigma(t)) * rng.randn(1, 3).astype(np.float32)
    axis = rng.randn(1, 3)
    axis /= np.linalg.norm(axis)
    cdf = np.asarray(so3.cdf[int(so3.t_to_idx(t))])
    angle = np.interp(rng.rand(), cdf, np.asarray(so3.discrete_omega))
    rot = (axis * angle).astype(np.float32)
    f32 = lambda x: np.asarray(x, np.float32)
    return {"t": t, "tr_update": tr, "tr_score_gt": f32(r3.score(tr, t)),
            "tr_scale": f32(r3.score_scaling(t)), "rot_update": rot,
            "rot_score_gt": f32(so3.score(jnp.asarray(rot), t)),
            "rot_scale": f32(so3.score_scaling(t))}


def check_weights(got, want, start, lr, k, label):
    """The port's weights after step k against JAX's (module docstring)."""
    bulk = BULK_REL * lr * k
    cap = 2 * ADAM_MAX * lr * k
    over, total, worst = 0, 0, 0.0
    for name, w in want.items():
        g = got[name].detach().numpy()
        if name.endswith("t_embed.W"):
            np.testing.assert_array_equal(g, start[name], err_msg=f"{label}: {name} moved")
            np.testing.assert_array_equal(w, start[name], err_msg=f"{label}: JAX {name} moved")
            continue
        err = np.abs(g.astype(np.float64) - w)
        assert np.isfinite(g).all(), f"{label}: {name}"
        assert err.max() <= cap, f"{label}: {name} off by {err.max():.3e} > {cap:.3e}"
        ulp = np.finfo(np.float32).eps * np.abs(w)
        over += int((err > bulk + ulp).sum())
        total += err.size
        worst = max(worst, float(err.max()))
    assert over <= TAIL_FRAC * total, (
        f"{label}: {over} of {total} elements beyond {bulk:.3e} (worst {worst:.3e})")


@pytest.fixture(scope="module")
def diffusers():
    return (JaxR3(JaxR3Config()), JaxSO3(JaxSO3Config()), R3Diffuser(R3Config()),
            SO3Diffuser(SO3Config()))


@pytest.mark.parametrize("lineage", sorted(PROTOCOLS))
def test_training_trajectory_matches_jax(lineage, diffusers):
    jcfg, pcfg = configs(sample_size=0)
    jexp = JaxExperimentConfig(**PROTOCOLS[lineage])
    pexp = ExperimentConfig(**PROTOCOLS[lineage])
    jr3, jso3, pr3, pso3 = diffusers
    if lineage == "mlsb":
        jnet, pnet, jfn, pfn = JaxScoreNet(jcfg), ScoreNet(pcfg), jax_loss, loss_fn
    else:
        jnet, pnet, jfn, pfn = JaxEGNNNet(jcfg), EGNNNet(pcfg), jax_dfmdock_loss, dfmdock_loss_fn
    params = jnet.init(jax.random.PRNGKey(4))
    pnet.load_state_dict(to_state_dict(jax_flat(params)))
    start = {k: v.numpy().copy() for k, v in to_state_dict(jax_flat(params)).items()}
    jopt = jax_make_optimizer(params, jexp)
    state = jopt.init(params)
    popt = make_optimizer(pnet, pexp)
    complexes = [padded(40, 30, seed=5, pad_to=PAD), padded(34, 26, seed=9, pad_to=PAD)]
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, b, key, inj: jfn(p, jnet, jr3, jso3, b, key, jexp, injected=inj),
        has_aux=True))
    rng = np.random.RandomState(0)
    for step in range(STEPS[lineage]):
        batch = complexes[step % 2]
        inj = draws(rng, jr3, jso3)
        key = jax.random.PRNGKey(100 + step)
        jb = jax_batch(batch, 0.0)
        del jb["t"]
        (_, jterms), grads = grad_fn(params, jb, key, inj)
        updates, state = jopt.update(grads, state, params)
        params = optax.apply_updates(params, updates)

        pinj = {**inj, **jax_contrastive_draws(key, jexp, jr3, jso3, inj["t"])}
        popt.zero_grad(set_to_none=True)
        loss, pterms = pfn(pnet, pr3, pso3, port_batch(batch), torch.Generator().manual_seed(0),
                           pexp, injected=pinj)
        loss.backward()
        popt.step()

        label = f"{lineage} step {step + 1}"
        assert sorted(jterms) == sorted(pterms), label
        for k, v in jterms.items():
            j, p = float(v), float(pterms[k].detach())
            assert abs(p - j) <= LOSS_REL * abs(j) + 1e-6, f"{label} {k}: port {p} jax {j}"
        want = {k: v.numpy().astype(np.float64)
                for k, v in to_state_dict(jax_flat(params)).items()}
        got = pnet.state_dict()
        assert sorted(got) == sorted(want), label
        check_weights(got, want, start, pexp.lr, step + 1, label)
