"""Training losses of the DFMDock lineage (mirrors
`dfmdock_tpu/train/dfmdock_losses.py`; reference src/models/DFMDock.py:77-244).

Against the mlsb loss (train/losses.py): the ligand centre is the mean over
all backbone atoms, a confidence head is supervised with the label
l_RMSD < 5 A, a 64-bin distogram cross-entropy runs inside the net's pair
loop, and the auxiliary terms are weighted 0.1:

  loss = tr + rot + 0.1 * (ec + contrastive + confidence + distogram + ires)
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from dfmdock_tpu_torch.config import ExperimentConfig
from dfmdock_tpu_torch.features.sixd import pairwise_ca_dist
from dfmdock_tpu_torch.geom import axis_angle_to_matrix
from dfmdock_tpu_torch.train.losses import (
    _bce_logits,
    draw_perturbation,
    ec_loss_of,
    interface_labels,
    score_losses,
)


def _lig_bb_center(pos, lig_valid):
    n = lig_valid.sum().clamp(min=1.0)
    return (pos * lig_valid[:, None, None]).sum((0, 1)) / (3.0 * n)


def _modify_coords_bb(pos, lig_valid, rot_aa, tr):
    """Rigid ligand update about the all-backbone-atom mean (DFMDock.py:246-252).
    pos [N, 3, 3], rot_aa / tr [1, 3]."""
    cen = _lig_bb_center(pos, lig_valid)
    rot = axis_angle_to_matrix(rot_aa.reshape(3))
    new_lig = (pos - cen) @ rot.T + cen + tr.reshape(3)
    return torch.where(lig_valid[:, None, None] > 0, new_lig, pos)


def _center_on_lig(pos, lig_valid):
    return pos - _lig_bb_center(pos, lig_valid)


def dfmdock_loss_fn(net, r3, so3, batch, generator, exp: ExperimentConfig, injected=None):
    """One training example's DFMDock losses: (total, {term: 0-d tensor});
    arguments as `losses.loss_fn`."""
    device = batch["pos"].device
    valid = batch["node_mask"].to(torch.float32)
    lig_valid = batch["lig_mask"] * valid
    n_lig = lig_valid.sum().clamp(min=1.0)
    zero = torch.zeros((), device=device)

    t, tr_scale, tr_update, tr_score_gt, rot_scale, rot_update, rot_score_gt = (
        draw_perturbation(r3, so3, exp, generator, device, injected))
    gt_pos = batch["pos"]
    noised_pos = _modify_coords_bb(gt_pos, lig_valid, rot_update, tr_update)

    # l_RMSD between the noised and native ligand CAs: the confidence label
    dca = ((noised_pos[:, 1, :] - gt_pos[:, 1, :]) ** 2).sum(-1)
    l_rmsd = torch.sqrt((dca * lig_valid).sum() / n_lig)

    noised_c = _center_on_lig(noised_pos, lig_valid)
    gt_c = _center_on_lig(gt_pos, lig_valid)
    gt_dist = pairwise_ca_dist(gt_c[None]) if exp.use_dist_loss else None
    out = net.apply_train(batch, noised_c[None], t, generator=generator,
                          dedx=exp.grad_energy, gt_dist=gt_dist)

    ec_loss = ec_loss_of(exp, out, lig_valid, n_lig) if exp.grad_energy else zero
    tr_loss, rot_loss = score_losses(exp, out, tr_score_gt, tr_scale, rot_score_gt, rot_scale)
    if exp.use_contrastive_loss:
        energy_gt = net.apply_train(batch, gt_c[None], t, generator=generator,
                                    return_energy=True)[0]
        el_loss = F.softplus(energy_gt - out["energy"][0])
    else:
        el_loss = zero
    dist_loss = out["dist_loss"][0] if exp.use_dist_loss else zero
    if exp.use_interface_loss:
        labels = interface_labels(gt_pos, batch["lig_mask"], batch["node_mask"])
        ires_loss = _bce_logits(out["ires_logits"][0], labels, valid)
    else:
        ires_loss = zero
    if exp.use_confidence_loss:
        label = (l_rmsd < 5.0).to(torch.float32)
        logit = out["confidence_logits"][0]
        conf_loss = (torch.clamp(logit, min=0) - logit * label
                     + torch.log1p(torch.exp(-logit.abs())))
    else:
        conf_loss = zero

    loss = tr_loss + rot_loss + 0.1 * (ec_loss + el_loss + conf_loss + dist_loss + ires_loss)
    return loss, {"tr_loss": tr_loss, "rot_loss": rot_loss, "ec_loss": ec_loss,
                  "el_loss": el_loss, "dist_loss": dist_loss, "ires_loss": ires_loss,
                  "conf_loss": conf_loss, "l_rmsd": l_rmsd, "loss": loss}
