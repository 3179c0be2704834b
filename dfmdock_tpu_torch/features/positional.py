"""AF2-multimer relative position class (66-way): dense, at selected
neighbours, and as a one-hot.

Offsets are clipped to +-32 within a chain (65 classes) plus one cross-chain
class, as in `dfmdock_tpu/features/positional.py`.
"""
from __future__ import annotations

import torch

MAX_RELATIVE_IDX = 32
NUM_RELPOS_CLASSES = 2 * MAX_RELATIVE_IDX + 2  # 66


def relpos_bin_at(res_id: torch.Tensor, asym_id: torch.Tensor, idx: torch.Tensor):
    """res_id/asym_id [N] int, idx [..., N, K] -> [..., N, K] int32 class."""
    res_j = res_id[idx.long()]
    asym_j = asym_id[idx.long()]
    same_chain = asym_id[:, None] == asym_j
    offset = res_id[:, None] - res_j
    clipped = torch.clamp(offset + MAX_RELATIVE_IDX, 0, 2 * MAX_RELATIVE_IDX)
    cross = torch.full_like(clipped, 2 * MAX_RELATIVE_IDX + 1)
    return torch.where(same_chain, clipped, cross).to(torch.int32)


def relpos_bin(res_id: torch.Tensor, asym_id: torch.Tensor) -> torch.Tensor:
    """[N] residue ids and [N] chain ids -> [N, N] int32 class in [0, 65]."""
    n = res_id.shape[0]
    idx = torch.arange(n, device=res_id.device).expand(n, n)
    return relpos_bin_at(res_id, asym_id, idx)


def relpos_onehot(res_id: torch.Tensor, asym_id: torch.Tensor) -> torch.Tensor:
    """Dense [N, N, 66] float32 one-hot of relpos_bin."""
    return torch.nn.functional.one_hot(relpos_bin(res_id, asym_id).long(),
                                       NUM_RELPOS_CLASSES).to(torch.float32)
