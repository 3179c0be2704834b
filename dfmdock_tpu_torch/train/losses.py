"""The loss pieces that pose ranking reads (from `dfmdock_tpu/train/losses.py`).

Training is not ported yet; the ranking keys score a pose by the interface
self-consistency of its predicted interface residues (`icons`): the BCE of
the net's `ires` logits against the interface the pose itself forms.
Functions take a leading pose dimension.
"""
from __future__ import annotations

import torch


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
