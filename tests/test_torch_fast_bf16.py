"""The kernel route at the JAX package's own precision: the port's
`ModelConfig.fast()` (bf16 products, ops/fused_egcl in its single-pass bf16
mode; on CPU tensors the kernels' plain versions) against the JAX nets at
`ModelConfig.fast()` (bf16, its Pallas kernels in interpret mode), both
lineages, the same weights (params.py), two poses batched on the port's
leading axis and JAX's own Gumbel noise injected, so both select the same
edges.

Both sides round the same values to bf16, so they differ where a float32
sum ahead of a rounding, taken in another order, tips a value across a bf16
rounding boundary, and by one formula: the port's energy head is its port
of the JAX package's float32 Pallas head (ops/energy_head), while the JAX
ScoreNet runs its XLA head, whose last product is cast (~1e-3 of the
energy).  Scores, energies and the confidence logit are held within 2^-8
(one bf16 step) of their largest: measured <= 2.3e-3 (the mlsb rot_score).
The interface logits read h after the last layer's node update, which no
score depends on, and where a tie shows most: they are held within 5e-2 of
their largest (measured 1.5e-2 to 2.1e-2).  That is noise, not a formula:
on the same case the JAX package's own eager bf16 route lies 2.4e-2 from
its fast() in ires, the port's eager bf16 route 1.3e-2 from JAX's eager
bf16, and the port's float32 kernel route lies further from JAX's fast()
than its bf16 route in every output (e.g. energy 7.8e-3 against 9.2e-4).
num_clashes exact.  Small widths (tests/_torch_parity.SMALL).
"""
import jax
import numpy as np
import pytest
import torch

import _torch_parity as tp
from dfmdock_tpu.config import ModelConfig as JaxModelConfig
from dfmdock_tpu.models import ScoreNet as JaxScoreNet
from dfmdock_tpu.models.dfmdock import DFMDockModel as JaxDFMDock
from dfmdock_tpu_torch.config import ModelConfig
from dfmdock_tpu_torch.models import DFMDockModel, ScoreNet
from dfmdock_tpu_torch.params import to_state_dict

OUT_REL = 2.0**-8
IRES_REL = 5e-2
LINEAGES = {
    "mlsb": (JaxScoreNet, ScoreNet, ("tr_score", "rot_score", "f", "energy"), "ires"),
    "dfmdock": (JaxDFMDock, DFMDockModel,
                ("tr_score", "rot_score", "f", "energy", "confidence_logits"), "ires_logits"),
}


@pytest.mark.parametrize("lineage", sorted(LINEAGES))
def test_fast_matches_jax_fast(lineage):
    jax_cls, port_cls, outputs, ires = LINEAGES[lineage]
    jc, pc = JaxModelConfig.fast(**tp.SMALL), ModelConfig.fast(**tp.SMALL)
    assert jc.compute_dtype == pc.compute_dtype == "bfloat16"
    params = jax_cls(jc).init(jax.random.PRNGKey(5))
    b = tp.padded(70, 50, seed=21)
    n = b["pos"].shape[0]
    pos2 = b["pos"].copy()
    pos2[70:120] += np.float32([2.0, -1.0, 0.5])
    outs_j, gumbels = [], []
    for i, pos in enumerate((b["pos"], pos2)):
        key = jax.random.PRNGKey(30 + i)
        outs_j.append(jax_cls(jc).apply(params, tp.jax_batch({**b, "pos": pos}, 0.4), key,
                                        predict=True))
        k_edges, _ = jax.random.split(key)
        gumbels.append(np.asarray(jax.random.gumbel(k_edges, (n, n))))
    net = port_cls(pc)
    net.load_state_dict(to_state_dict(tp.jax_flat(params)))
    net.eval()
    pb = tp.port_batch(b)
    with torch.no_grad():
        out_p = net(pb, torch.from_numpy(np.stack([b["pos"], pos2])), 0.4,
                    gumbel=torch.from_numpy(np.stack(gumbels)))
    for i, out_j in enumerate(outs_j):
        for k in outputs:
            tp.assert_close(out_p[k][i].numpy(), out_j[k], OUT_REL, k)
        tp.assert_close(out_p[ires][i].numpy(), out_j[ires], IRES_REL, ires)
        assert int(out_p["num_clashes"][i]) == int(out_j["num_clashes"])
