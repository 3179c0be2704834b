"""Training losses and their gradients: the port against the JAX package.

Both sides take the same numpy-seeded complex and weights, the same
injected perturbation, dropout 0 and deterministic edges (the 20 nearest
neighbours, sample_size 0: torch and JAX RNGs cannot match).  Every loss
term of `loss_fn` (mlsb) and `dfmdock_loss_fn` (DFMDock lineage), the
contrastive variants included, within rel 1e-4; the gradients of the total
loss with respect to every weight, second order through dedx included
(--grad-energy), within rel 1e-3 of the largest gradient of each array.
The contrastive variants' own draws (t_c, the K negatives, the clash
offsets) are taken from the JAX keys here and injected into the port.

The JAX package gathers rows by one-hot bf16 matmuls (`ops/gather.py`):
exact forward, but the backward takes the transpose product of the bf16
cast of the cotangent, so its gradients through every EGCL gather carry
bf16 rounding (scripts/f5_gather_gradient.py measures it).  The gradient
tests hold the port to the f32 reference: the JAX package with
`gather_rows` replaced by an exact indexing gather (`jnp.take`), whose
forward is bit-equal to it.
"""
import jax
import jax.numpy as jnp
import numpy as np
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
from dfmdock_tpu_torch.config import ExperimentConfig, R3Config, SO3Config
from dfmdock_tpu_torch.diffusion import R3Diffuser, SO3Diffuser
from dfmdock_tpu_torch.models import EGNNNet, ScoreNet
from dfmdock_tpu_torch.params import to_state_dict
from dfmdock_tpu_torch.train.dfmdock_losses import dfmdock_loss_fn
from dfmdock_tpu_torch.train.losses import _EPS_T, loss_fn

LOSS_REL = 1e-4  # f32 on both sides, the same arithmetic up to summation order
GRAD_REL = 1e-3  # second-order gradients through 2 EGCL layers and the heads
R3C, SO3C = R3Config(), SO3Config()


@pytest.fixture(autouse=True)
def exact_gather(monkeypatch):
    """The f32 reference's gather: src[idx], with an exact backward."""
    import dfmdock_tpu.ops.gather as gather

    monkeypatch.setattr(gather, "gather_rows", lambda src, idx: jnp.take(src, idx, axis=0))


@pytest.fixture(scope="module")
def diffusers():
    return (JaxR3(JaxR3Config()), JaxSO3(JaxSO3Config()), R3Diffuser(R3C), SO3Diffuser(SO3C))


def injected_perturbation(seed):
    rng = np.random.RandomState(seed)
    return {"t": np.float32(0.35), "tr_update": rng.randn(1, 3).astype(np.float32) * 3,
            "tr_score_gt": rng.randn(1, 3).astype(np.float32),
            "tr_scale": np.float32(0.4),
            "rot_update": rng.randn(1, 3).astype(np.float32) * 0.4,
            "rot_score_gt": rng.randn(1, 3).astype(np.float32),
            "rot_scale": np.float32(0.8)}


def jax_contrastive_draws(key, exp, r3, so3, t):
    """The draws the JAX loss takes from its keys for the contrastive
    negatives (dfmdock_tpu/train/losses.py), to inject into the port."""
    _, _, k_net_gt = jax.random.split(key, 3)
    if exp.contrastive_t_max > 0.0:
        k_tc = jax.random.fold_in(k_net_gt, 777)
        t_c = _EPS_T + jax.random.uniform(k_tc) * (exp.contrastive_t_max - _EPS_T)
    else:
        t_c = jnp.float32(t)
    neg_tr, neg_rot = [], []
    for i in range(exp.contrastive_negatives):
        k_tr_i, k_rot_i, _ = jax.random.split(jax.random.fold_in(k_net_gt, 1 + i), 3)
        neg_tr.append(np.asarray(r3.forward_marginal(k_tr_i, t_c)[0])[0])
        neg_rot.append(np.asarray(so3.forward_marginal(k_rot_i, t_c)[0])[0])
    deltas = [float(jax.random.uniform(jax.random.split(jax.random.fold_in(k_net_gt, 101 + i))[0],
                                       minval=1.0, maxval=5.0))
              for i in range(exp.contrastive_clash_negatives)]
    return {"t_c": float(t_c), "neg_tr": np.array(neg_tr), "neg_rot": np.array(neg_rot),
            "clash_delta": np.array(deltas)}


def run_both(lineage, exp_kw, diffusers, seed=3, jit=False, **cfg_kw):
    jcfg, pcfg = configs(sample_size=0, **cfg_kw)
    jexp, pexp = JaxExperimentConfig(**exp_kw), ExperimentConfig(**exp_kw)
    jr3, jso3, pr3, pso3 = diffusers
    if lineage == "mlsb":
        jnet, pnet, jfn, pfn = JaxScoreNet(jcfg), ScoreNet(pcfg), jax_loss, loss_fn
    else:
        jnet, pnet, jfn, pfn = JaxEGNNNet(jcfg), EGNNNet(pcfg), jax_dfmdock_loss, dfmdock_loss_fn
    params = jnet.init(jax.random.PRNGKey(seed))
    pnet.load_state_dict(to_state_dict(jax_flat(params)))
    batch = padded(40, 30, seed=seed)
    inj = injected_perturbation(seed)
    key = jax.random.PRNGKey(11)

    def jloss(p):
        jb = jax_batch(batch, 0.0)
        del jb["t"]
        return jfn(p, jnet, jr3, jso3, jb, key, jexp, injected=inj)

    # eager: XLA's fused CPU kernels under jax.jit round differently, and
    # these random-init gradients (the unit vector of a tiny force, the
    # axis of a tiny dedx row) amplify that past GRAD_REL; the eager loss is
    # the same f32 arithmetic as the port's.  `jit` (tests/test_torch_bf16.py)
    # compiles it: at bf16 the rounding ties dominate either way, and the
    # eager second-order step takes ~20 s more.
    grad_fn = jax.value_and_grad(jloss, has_aux=True)
    (jl, jterms), jgrads = (jax.jit(grad_fn) if jit else grad_fn)(params)
    pinj = {**inj, **jax_contrastive_draws(key, jexp, jr3, jso3, inj["t"])}
    pl, pterms = pfn(pnet, pr3, pso3, port_batch(batch), torch.Generator().manual_seed(0),
                     pexp, injected=pinj)
    pl.backward()
    return jterms, pterms, to_state_dict(jax_flat(jgrads)), dict(pnet.named_parameters())


def check(jterms, pterms, jgrads, pparams, loss_rel=LOSS_REL, grad_rel=GRAD_REL,
          grad_floor=1e-7):
    """Every loss term within loss_rel, every weight's gradient within
    grad_rel of its largest plus grad_floor."""
    assert sorted(jterms) == sorted(pterms)
    for k in jterms:
        j, p = float(jterms[k]), float(pterms[k].detach())
        assert np.isfinite(p), k
        assert abs(p - j) <= loss_rel * abs(j) + 1e-6, f"{k}: port {p} jax {j}"
    assert set(pparams) <= set(jgrads)
    for name, param in pparams.items():
        g_p = param.grad.numpy() if param.grad is not None else np.zeros(param.shape)
        g_j = jgrads[name].numpy()
        err = np.abs(g_p - g_j).max()
        assert np.isfinite(g_p).all(), name
        assert err <= grad_rel * np.abs(g_j).max() + grad_floor, f"{name}: grad err {err:.3e}"


MLSB_CASES = {
    "plain": dict(),
    "grad_energy": dict(grad_energy=True),
    "grad_energy_joint_form": dict(grad_energy=True, separate_energy_loss=False,
                                   separate_tr_loss=False, separate_rot_loss=False),
    "contrastive": dict(grad_energy=True, use_contrastive_loss=True,
                        contrastive_weight=0.5, contrastive_margin=0.3),
    "contrastive_t_max": dict(use_contrastive_loss=True, contrastive_t_max=0.2),
    "infonce_k3": dict(use_contrastive_loss=True, contrastive_negatives=3),
    "clash_negatives": dict(use_contrastive_loss=True, contrastive_clash_negatives=2,
                            contrastive_t_max=0.3),
    "no_interface": dict(use_interface_loss=False, perturb_rot=False),
}


@pytest.mark.parametrize("case", sorted(MLSB_CASES))
def test_mlsb_loss_and_grads_match_jax(case, diffusers):
    check(*run_both("mlsb", MLSB_CASES[case], diffusers))


DFMDOCK_CASES = {
    "plain": dict(),
    "all_terms": dict(grad_energy=True, use_contrastive_loss=True, use_confidence_loss=True,
                      use_dist_loss=True),
    "joint_form": dict(grad_energy=True, separate_energy_loss=False, separate_tr_loss=False,
                       use_dist_loss=True),
}


@pytest.mark.parametrize("case", sorted(DFMDOCK_CASES))
def test_dfmdock_loss_and_grads_match_jax(case, diffusers):
    check(*run_both("dfmdock", DFMDOCK_CASES[case], diffusers))


def test_score_and_marginal_are_exact(diffusers):
    """score_scaling and forward_marginal of both diffusers equal JAX's
    formulas on the same t and the same standard-normal / axis-angle draw."""
    jr3, jso3, pr3, pso3 = diffusers
    for t in (1e-5, 0.05, 0.37, 0.999):
        tt = torch.tensor(t)
        assert float(pr3.score_scaling(tt)) == pytest.approx(float(jr3.score_scaling(t)),
                                                             rel=1e-6)
        assert float(pso3.score_scaling(tt)) == float(jso3.score_scaling(jnp.float32(t)))
        g = torch.Generator().manual_seed(1)
        tr, score = pr3.forward_marginal(g, tt)
        z = torch.randn((1, 3), generator=torch.Generator().manual_seed(1))
        np.testing.assert_allclose(tr.numpy(), (jr3.sigma(t) * z).numpy(), rtol=1e-6)
        np.testing.assert_allclose(score.numpy(), np.asarray(jr3.score(tr.numpy(), t)),
                                   rtol=1e-5)
        rot, rscore = pso3.forward_marginal(torch.Generator().manual_seed(2), tt)
        np.testing.assert_allclose(
            rscore.numpy(), np.asarray(jso3.score(jnp.asarray(rot.numpy()), jnp.float32(t))),
            rtol=2e-4, atol=1e-5)
