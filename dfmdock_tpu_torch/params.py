"""Parameter bridge between the JAX package's pytree and the port's state_dict.

The JAX score networks (ScoreNet, and EGNNNet of the DFMDock lineage) keep
their parameters as nested dicts and lists, flattened here to "/"-joined
paths ("egnn/3/edge_mlp/l0/w", "to_force/l0/w").  Linear weights there are
w: [in, out]; here they are nn.Linear weights [out, in].  Names map as
  .../w -> ....weight (transposed)    .../b -> ....bias
  .../g -> ....weight (norm scale)    anything else keeps its name
(`mean_scale` of GraphNorm, the Fourier buffer `W`).

A flat dict saved with `numpy.savez` is what the CLIs' `--ckpt` reads;
`scripts/export_torch_weights.py` writes one from a JAX orbax checkpoint
(`ckpts/db5_demo/weights.npz`, `ckpts/db5_holdout_dfmdock/weights.npz`).
"""
from __future__ import annotations

import numpy as np
import torch

_TO_TORCH = {"w": "weight", "b": "bias", "g": "weight"}


def to_state_dict(flat: dict) -> dict:
    """{jax path: array} -> {state_dict key: tensor}."""
    out = {}
    for path, value in flat.items():
        *parents, leaf = path.split("/")
        arr = np.asarray(value)
        if leaf == "w":
            arr = arr.T
        key = ".".join(parents + [_TO_TORCH.get(leaf, leaf)])
        if key in out:
            raise ValueError(f"two parameters map to {key}")
        out[key] = torch.tensor(arr)
    return out


def to_flat(state_dict: dict) -> dict:
    """{state_dict key: tensor} -> {jax path: float32 numpy array}."""
    out = {}
    for key, value in state_dict.items():
        *parents, leaf = key.split(".")
        arr = value.detach().cpu().numpy()
        if leaf == "weight":
            leaf, arr = ("w", arr.T) if arr.ndim == 2 else ("g", arr)
        elif leaf == "bias":
            leaf = "b"
        out["/".join(parents + [leaf])] = np.ascontiguousarray(arr)
    return out


def load_npz(path: str) -> dict:
    """The state_dict of a flat-dict .npz (see the module docstring)."""
    with np.load(path) as z:
        return to_state_dict({k: z[k] for k in z.files})
