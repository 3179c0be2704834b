"""ROADMAP F5: the JAX package's gather rounds its gradient to bf16.

    python3 scripts/f5_gather_gradient.py

On the CPU, at the size of the port's loss tests (node 32, depth 2, random
init, a 40 + 30 residue complex, kNN edges, an injected perturbation), the
mlsb loss with --grad-energy is differentiated three ways: the JAX package
as it is (its `gather_rows` takes one-hot bf16 products), the JAX package
with `gather_rows` replaced by an exact `jnp.take`, and the port.  Prints,
for dedx and for the weight gradients, the largest difference of each JAX
variant from the port relative to the largest value.  Imports JAX; not
part of the port.
"""
from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch

    import dfmdock_tpu.ops.gather as gather
    from _torch_parity import configs, jax_batch, jax_flat, padded, port_batch, port_net
    from dfmdock_tpu.models import ScoreNet as JaxScoreNet

    jcfg, pcfg = configs(sample_size=0)
    net = JaxScoreNet(jcfg)
    params = net.init(jax.random.PRNGKey(3))
    port = port_net(pcfg, params)
    batch = padded(40, 30, seed=3)
    out = port.apply_train(port_batch(batch), torch.from_numpy(batch["pos"])[None],
                           torch.tensor(0.35), dedx=True)
    want = out["dedx"][0].detach().numpy()
    (out["energy"].sum() + (out["dedx"] ** 2).sum()).backward()
    port_grads = {k: p.grad.numpy() for k, p in port.named_parameters() if p.grad is not None}

    def jax_side():
        def scalar(p):
            o = net.apply(p, jax_batch(batch, 0.35), jax.random.PRNGKey(0), train=True)
            return o["energy"] + (o["dedx"] ** 2).sum(), o["dedx"]

        (_, dedx), grads = jax.value_and_grad(scalar, has_aux=True)(params)
        from dfmdock_tpu_torch.params import to_state_dict

        return np.asarray(dedx), {k: v.numpy() for k, v in to_state_dict(jax_flat(grads)).items()}

    exact = gather.gather_rows
    for label in ("bf16 gather (as shipped)", "exact gather (jnp.take)"):
        if label.startswith("exact"):
            gather.gather_rows = lambda src, idx: jnp.take(src, idx, axis=0)
        dedx, grads = jax_side()
        rows = np.linalg.norm(want, axis=-1) > 0
        row_rel = (np.linalg.norm(dedx - want, axis=-1)[rows]
                   / np.linalg.norm(want, axis=-1)[rows]).max()
        g_rel = max(np.abs(grads[k] - g).max() / (np.abs(g).max() + 1e-30)
                    for k, g in port_grads.items() if np.abs(g).max() > 1e-6)
        print(f"JAX with the {label} against the port: dedx worst row {row_rel:.3e} of its "
              f"norm; weight gradients (E + |dedx|^2) worst {g_rel:.3e} of their array's "
              "largest")
    gather.gather_rows = exact


if __name__ == "__main__":
    main()
