"""Shared fixtures for the port's parity tests: the same numpy-seeded inputs
and weights go through the JAX package and through dfmdock_tpu_torch."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dfmdock_tpu.config import ModelConfig as JaxModelConfig
from dfmdock_tpu.data.batching import pad_complex as jax_pad_complex
from dfmdock_tpu_torch.config import ModelConfig
from dfmdock_tpu_torch.models import ScoreNet
from dfmdock_tpu_torch.params import to_state_dict

SMALL = dict(lm_embed_dim=32, node_dim=32, edge_dim=16, inner_dim=16, depth=2,
             dropout=0.0)


def configs(**kw):
    """(JAX ModelConfig, port ModelConfig) with the same fields."""
    fields = {**SMALL, **kw}
    return JaxModelConfig(**fields), ModelConfig(**fields)


def jax_flat(params) -> dict:
    """JAX param pytree -> {"a/b/0/w": numpy array}."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        out[key] = np.asarray(leaf)
    return out


def port_net(cfg: ModelConfig, params) -> ScoreNet:
    """The port's ScoreNet on the CPU carrying the JAX params."""
    net = ScoreNet(cfg)
    net.load_state_dict(to_state_dict(jax_flat(params)))
    return net.eval()


def make_complex(n_rec, n_lig, feat, seed):
    """Random-walk CA traces with non-collinear N/CA/C offsets (a collinear
    backbone puts every dihedral on a bin boundary)."""
    rng = np.random.RandomState(seed)
    rec_ca = np.cumsum(rng.randn(n_rec, 3) * 2 + [3.8, 0, 0], axis=0)
    lig_ca = np.cumsum(rng.randn(n_lig, 3) * 2 + [3.8, 0, 0], axis=0) + [10, 5, 0]
    d_n = np.float32([-1.2, 0.6, 0.3]) + rng.randn(n_rec + n_lig, 3) * 0.05
    d_c = np.float32([1.3, -0.4, 0.5]) + rng.randn(n_rec + n_lig, 3) * 0.05
    rec_pos = np.stack([rec_ca + d_n[:n_rec], rec_ca, rec_ca + d_c[:n_rec]], 1)
    lig_pos = np.stack([lig_ca + d_n[n_rec:], lig_ca, lig_ca + d_c[n_rec:]], 1)
    return (
        rng.randn(n_rec, feat).astype(np.float32),
        rng.randn(n_lig, feat).astype(np.float32),
        rec_pos.astype(np.float32),
        lig_pos.astype(np.float32),
    )


def padded(n_rec, n_lig, feat=32, seed=13, pad_to=None) -> dict:
    return jax_pad_complex(*make_complex(n_rec, n_lig, feat, seed), pad_to=pad_to)


def jax_batch(batch: dict, t: float) -> dict:
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    b["t"] = jnp.float32(t)
    return b


def port_batch(batch: dict) -> dict:
    keys = ("x", "pos", "node_mask", "lig_mask", "res_id", "asym_id")
    return {k: torch.from_numpy(np.asarray(batch[k])) for k in keys}


def assert_close(port, ref, rel, name=""):
    """max |port - ref| <= rel * max |ref| (+1e-6 absolute floor)."""
    port = np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape, (name, port.shape, ref.shape)
    err = np.abs(port - ref).max() if ref.size else 0.0
    bound = rel * np.abs(ref).max() + 1e-6
    assert err <= bound, f"{name}: max abs err {err:.3e} > {bound:.3e}"
