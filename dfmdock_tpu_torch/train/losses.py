"""Training losses of the mlsb lineage (mirrors `dfmdock_tpu/train/losses.py`).

One training example: draw t ~ U(eps, 1) and the forward rotation and
translation perturbations, move the ligand, run the net in train mode and
combine

  tr + rot + ec + contrastive + interface

(each score term optionally in the separate axis / angle form).  Every
reduction is masked, so padded rows add nothing.  Randomness comes from one
`torch.Generator` (the draws, then the net's edge noise and dropout), so a
run is repeatable for a seed but does not reproduce the JAX package's keys;
`injected` supplies every draw instead, for deterministic evaluation and
parity with the JAX package.

The ranking keys (`icons`) read `interface_labels` and `_bce_logits` with a
leading pose dimension; the loss uses them on one pose ([1, ...]).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from dfmdock_tpu_torch.config import ExperimentConfig
from dfmdock_tpu_torch.sampler.em import modify_coords

_EPS_T = 1e-5
PERTURBATION_KEYS = ("t", "tr_update", "tr_score_gt", "tr_scale", "rot_update",
                     "rot_score_gt", "rot_scale")


def interface_labels(pos, lig_mask, node_mask, threshold: float = 8.0):
    """[..., N, 1] binary interface labels of pos [..., N, 3, 3]: CA within
    8 A of a CA of the other chain (reference ppi_dataset.py:105-123)."""
    valid = node_mask.to(torch.float32)
    lig = lig_mask * valid
    rec = (1.0 - lig_mask) * valid
    ca = pos[..., 1, :]
    diff = ca[..., :, None, :] - ca[..., None, :, :]
    d = torch.sqrt(torch.clamp((diff * diff).sum(-1), min=1e-12))
    close = (d < threshold) & (rec[:, None] * lig[None, :] > 0)
    is_iface = close.any(-1) | close.any(-2)
    return (is_iface.to(torch.float32) * valid)[..., None]


def _bce_logits(logits, labels, mask):
    """Masked mean binary cross-entropy with logits [..., N, 1] -> [...]."""
    per = torch.clamp(logits, min=0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))
    m = mask.to(torch.float32)[:, None]
    return (per * m).sum((-2, -1)) / torch.clamp(m.sum(), min=1.0)


def _safe_norm(x):
    """Norm over the last axis (kept) with a zero, not NaN, gradient at
    x == 0: the receptor and padding rows of f and dedx are exactly zero
    and the ec loss differentiates through them."""
    return torch.sqrt((x * x).sum(-1, keepdim=True) + 1e-24)


def _axis_angle_mse(pred, gt, scale, n=None):
    """0.5 * (axis MSE + angle MSE / scale^2) (score_model_mlsb.py:134-168);
    means over every element, or with `n` sums over n rows."""
    gt_angle = _safe_norm(gt)
    gt_axis = gt / (gt_angle + 1e-6)
    pred_angle = _safe_norm(pred)
    pred_axis = pred / (pred_angle + 1e-6)
    if n is None:
        axis_loss = ((pred_axis - gt_axis) ** 2).mean()
        angle_loss = ((pred_angle - gt_angle) ** 2 / scale**2).mean()
    else:
        axis_loss = ((pred_axis - gt_axis) ** 2).sum() / (3 * n)
        angle_loss = ((pred_angle - gt_angle) ** 2 / scale**2).sum() / n
    return 0.5 * (axis_loss + angle_loss)


def draw_perturbation(r3, so3, exp: ExperimentConfig, generator, device, injected=None):
    """t and the forward perturbations of one loss step with their scores
    and scalings (score_model_mlsb.py:66-94): (t, tr_scale, tr_update [1, 3],
    tr_score_gt [1, 3], rot_scale, rot_update [1, 3], rot_score_gt [1, 3]),
    tensors on `device`.  `injected` supplies every value (the keys of
    PERTURBATION_KEYS), taken in the default dtype (float32, or float64 in a
    float64 replay of a step)."""
    if injected is not None:
        val = lambda k: torch.as_tensor(injected[k], dtype=torch.get_default_dtype(),
                                        device=device)
        return (val("t"), val("tr_scale"), val("tr_update").reshape(1, 3),
                val("tr_score_gt").reshape(1, 3), val("rot_scale"),
                val("rot_update").reshape(1, 3), val("rot_score_gt").reshape(1, 3))
    t = torch.rand((), generator=generator, device=device) * (1.0 - _EPS_T) + _EPS_T
    one, zero = torch.ones((), device=device), torch.zeros((1, 3), device=device)
    if exp.perturb_tr:
        tr_scale = r3.score_scaling(t)
        tr_update, tr_score_gt = r3.forward_marginal(generator, t)
    else:
        tr_scale, tr_update, tr_score_gt = one, zero, zero
    if exp.perturb_rot:
        rot_scale = so3.score_scaling(t)
        rot_update, rot_score_gt = so3.forward_marginal(generator, t)
    else:
        rot_scale, rot_update, rot_score_gt = one, zero, zero
    return t, tr_scale, tr_update, tr_score_gt, rot_scale, rot_update, rot_score_gt


def score_losses(exp: ExperimentConfig, out, tr_score_gt, tr_scale, rot_score_gt, rot_scale):
    """The translation and rotation score-matching terms."""
    zero = torch.zeros((), device=tr_scale.device)
    tr_loss = rot_loss = zero
    if exp.perturb_tr:
        tr_loss = (_axis_angle_mse(out["tr_score"], tr_score_gt, tr_scale)
                   if exp.separate_tr_loss
                   else ((out["tr_score"] - tr_score_gt) ** 2 / tr_scale**2).mean())
    if exp.perturb_rot:
        rot_loss = (_axis_angle_mse(out["rot_score"], rot_score_gt, rot_scale)
                    if exp.separate_rot_loss
                    else ((out["rot_score"] - rot_score_gt) ** 2 / rot_scale**2).mean())
    return tr_loss, rot_loss


def ec_loss_of(exp: ExperimentConfig, out, lig_valid, n_lig):
    """Energy conservation: the force head against -dE/dx
    (score_model_mlsb.py:109-121)."""
    f, dedx = out["f"], out["dedx"]
    if exp.separate_energy_loss:
        return _axis_angle_mse(f, dedx, 1.0, n=n_lig)
    return ((dedx - f) ** 2 * lig_valid[:, None]).sum() / (3 * n_lig)


def _contrastive(net, r3, so3, batch, gt_pos, t, energy_noised, exp, generator,
                 injected):
    """The contrastive energy term: the native pose should have a lower
    energy than the noised one; cross-entropy over [-E_gt, -E_1..-E_K] with
    target 0, which for K = 1 is softplus(E_gt - E_noised + margin)
    (score_model_mlsb.py:177-185).  With contrastive_t_max > 0, K > 1
    negatives or clash negatives, the negatives are built here at t_c:
    forward perturbations at t_c (InfoNCE over K), and the native ligand
    pushed 1-5 A toward the receptor centroid (over-buried).  `injected`
    may give t_c, neg_tr / neg_rot [K, 3] and clash_delta [Kc]."""
    device = gt_pos.device
    lig_mask = batch["lig_mask"]
    margin = exp.contrastive_margin
    apply = lambda pos, tt: net.apply_train(batch, pos[None], tt, generator=generator,
                                            return_energy=True)[0]
    own_pair = (exp.contrastive_t_max > 0.0 or exp.contrastive_negatives > 1
                or exp.contrastive_clash_negatives > 0)
    if not own_pair:
        return F.softplus(apply(gt_pos, t) - energy_noised + margin)
    inj = injected or {}
    if "t_c" in inj:
        t_c = torch.as_tensor(inj["t_c"], dtype=torch.float32, device=device)
    elif exp.contrastive_t_max > 0.0:
        t_c = _EPS_T + torch.rand((), generator=generator, device=device) * (
            exp.contrastive_t_max - _EPS_T)
    else:
        t_c = t
    energy_gt = apply(gt_pos, t_c)
    gaps = []
    for i in range(exp.contrastive_negatives):
        if "neg_tr" in inj:
            tr_i = torch.as_tensor(inj["neg_tr"][i], dtype=torch.float32, device=device)
            rot_i = torch.as_tensor(inj["neg_rot"][i], dtype=torch.float32, device=device)
        else:
            tr_i, _ = r3.forward_marginal(generator, t_c)
            rot_i, _ = so3.forward_marginal(generator, t_c)
        neg = modify_coords(gt_pos[None], lig_mask, rot_i.reshape(1, 1, 3),
                            tr_i.reshape(1, 1, 3))[0]
        gaps.append(energy_gt - apply(neg, t_c) + margin)
    if exp.contrastive_clash_negatives > 0:
        valid = batch["node_mask"].to(torch.float32)
        lig_valid = lig_mask * valid
        rec_valid = (1.0 - lig_mask) * valid
        ca = gt_pos[:, 1, :]
        rec_c = (rec_valid[:, None] * ca).sum(0) / rec_valid.sum().clamp(min=1.0)
        lig_c = (lig_valid[:, None] * ca).sum(0) / lig_valid.sum().clamp(min=1.0)
        dirn = rec_c - lig_c
        dirn = dirn / torch.sqrt((dirn * dirn).sum()).clamp(min=1e-6)
        for i in range(exp.contrastive_clash_negatives):
            if "clash_delta" in inj:
                delta = torch.as_tensor(inj["clash_delta"][i], dtype=torch.float32,
                                        device=device)
            else:
                delta = 1.0 + 4.0 * torch.rand((), generator=generator, device=device)
            neg = modify_coords(gt_pos[None], lig_mask, torch.zeros((1, 1, 3), device=device),
                                (dirn * delta).reshape(1, 1, 3))[0]
            gaps.append(energy_gt - apply(neg, t_c) + margin)
    # log(1 + sum_i exp(gap_i)), with the max trick (gaps can be large early)
    g = torch.stack(gaps)
    m = g.max().clamp(min=0.0)
    return m + torch.log(torch.exp(-m) + torch.exp(g - m).sum())


def loss_fn(net, r3, so3, batch, generator, exp: ExperimentConfig, injected=None):
    """One training example's losses: (total, {term: 0-d tensor}).  batch
    holds one padded complex on the model's device (x, pos [N, 3, 3],
    node_mask, lig_mask, res_id, asym_id)."""
    device = batch["pos"].device
    valid = batch["node_mask"].to(torch.float32)
    lig_valid = batch["lig_mask"] * valid
    n_lig = lig_valid.sum().clamp(min=1.0)
    zero = torch.zeros((), device=device)

    t, tr_scale, tr_update, tr_score_gt, rot_scale, rot_update, rot_score_gt = (
        draw_perturbation(r3, so3, exp, generator, device, injected))
    gt_pos = batch["pos"]
    noised_pos = modify_coords(gt_pos[None], batch["lig_mask"], rot_update[None],
                               tr_update[None])
    out = net.apply_train(batch, noised_pos, t, generator=generator, dedx=exp.grad_energy)
    energy_noised = out["energy"][0]

    ec_loss = ec_loss_of(exp, out, lig_valid, n_lig) if exp.grad_energy else zero
    tr_loss, rot_loss = score_losses(exp, out, tr_score_gt, tr_scale, rot_score_gt, rot_scale)
    if exp.use_interface_loss:
        labels = batch.get("ires")
        if labels is None:
            labels = interface_labels(gt_pos, batch["lig_mask"], batch["node_mask"])
        ires_loss = _bce_logits(out["ires"][0], labels, valid)
    else:
        ires_loss = zero
    if exp.use_contrastive_loss:
        el_loss = exp.contrastive_weight * _contrastive(
            net, r3, so3, batch, gt_pos, t, energy_noised, exp, generator, injected)
    else:
        el_loss = zero

    loss = tr_loss + rot_loss + ec_loss + el_loss + ires_loss
    return loss, {"tr_loss": tr_loss, "rot_loss": rot_loss, "ec_loss": ec_loss,
                  "el_loss": el_loss, "ires_loss": ires_loss, "loss": loss}
