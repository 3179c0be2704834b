"""ESM2-650M per-residue embedding provider (mirrors `dfmdock_tpu/data/esm.py`).

The reference embeds sequences with facebook ESM2-650M at inference time
(repr layer 33, special tokens stripped).  Nothing is downloaded, so the
embeddings resolve in this order:

1. precomputed embeddings (the npz complexes carry them; the dock reads
   them and never asks a provider);
2. a locally cached HuggingFace `facebook/esm2_t33_650M_UR50D`;
3. otherwise an error that says what to do (`esm2.weights_unavailable`).

Backends (`--esm-backend`):
- `torch`: the port's own ESM2 (models/esm2.py) on the run's device, with
  the cached HF weights converted once; the JAX package's `jax` backend;
- `hf`: HuggingFace transformers' EsmModel on the run's device; the JAX
  package's `hf` backend (which runs on the CPU);
- `auto`: `torch`, else `hf`, as the JAX package's `auto` prefers `jax`.

`--one-hot-only` (the dock) skips the provider for models trained without
ESM features.
"""
from __future__ import annotations

import numpy as np
import torch

from dfmdock_tpu_torch.models.esm2 import (
    ESM2_650M,
    HF_ESM2_650M,
    embed_sequence,
    load_hf_esm2,
    weights_unavailable,
)

ESM_DIM = 1280
BACKENDS = ("auto", "torch", "hf")


class HFESMProvider:
    """HuggingFace transformers' EsmModel, loaded at the first embed."""

    def __init__(self, model_name: str = HF_ESM2_650M, device="cpu"):
        self._model = None
        self._tok = None
        self.model_name = model_name
        self.device = torch.device(device)

    def _load(self):
        if self._model is not None:
            return
        try:
            from transformers import AutoTokenizer, EsmModel

            self._tok = AutoTokenizer.from_pretrained(self.model_name, local_files_only=True)
            self._model = EsmModel.from_pretrained(
                self.model_name, local_files_only=True).to(self.device).eval()
        except (ImportError, OSError, ValueError) as e:
            raise weights_unavailable(self.model_name, e) from e

    def embed(self, seq: str) -> np.ndarray:
        """[L] sequence -> [L, 1280] float32 (last hidden layer, specials
        stripped: repr layer 33 of the fairseq esm API)."""
        self._load()
        inputs = self._tok(seq, return_tensors="pt", add_special_tokens=True)
        with torch.no_grad():
            out = self._model(**{k: v.to(self.device) for k, v in inputs.items()})
        rep = out.last_hidden_state[0, 1:-1, :].float().cpu().numpy()
        if rep.shape != (len(seq), ESM_DIM):
            raise ValueError(f"ESM2 embedding of shape {rep.shape} for {len(seq)} residues")
        return rep


class TorchESMProvider:
    """The port's ESM2 (models/esm2.py) on `device`, the cached HF weights
    converted at construction."""

    def __init__(self, device="cpu", model_name: str = HF_ESM2_650M):
        self.model = load_hf_esm2(model_name, ESM2_650M, device)

    def embed(self, seq: str) -> np.ndarray:
        return embed_sequence(self.model, seq).cpu().numpy()


def get_provider(backend: str = "auto", device="cpu"):
    """The provider of `backend` (see the module docstring) on `device`."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown ESM backend {backend!r}; one of {BACKENDS}")
    if backend == "hf":
        return HFESMProvider(device=device)
    if backend == "torch":
        return TorchESMProvider(device)
    try:
        return TorchESMProvider(device)
    except RuntimeError:
        return HFESMProvider(device=device)


def embeddings_available() -> bool:
    try:
        HFESMProvider()._load()
        return True
    except RuntimeError:
        return False
