"""DFMDockModel: EGNNNet on ligand-centred coordinates.

Mirrors `dfmdock_tpu/models/dfmdock.py`: the DFMDock-lineage net expects
coordinates centred on the ligand, here the mean over all three backbone
atoms of the ligand's valid rows, per pose (not the CA centroid that
ScoreNet's `center_in_net` uses).  The parameters are EGNNNet's, keyed
alike, so the same flat-dict weights load into either.
"""
from __future__ import annotations

import torch

from dfmdock_tpu_torch.models.egnn_net import EGNNNet


class DFMDockModel(EGNNNet):
    def forward(self, batch: dict, pos: torch.Tensor, t, **kwargs) -> dict:
        """EGNNNet.forward on pos [P, N, 3, 3] less each pose's ligand
        backbone centre."""
        lig_valid = batch["lig_mask"] * batch["node_mask"].to(torch.float32)
        n = lig_valid.sum().clamp(min=1.0)
        center = (pos * lig_valid[:, None, None]).sum((-3, -2)) / (3.0 * n)
        return super().forward(batch, pos - center[:, None, None, :], t, **kwargs)
