"""The committed JAX-free weights (scripts/export_torch_weights.py): each
`weights.npz` equal to its orbax step array for array, loaded strictly into
its port model, and the trained DFMDock-lineage forward at full width on
DB5 1QA9 against the JAX f32 forward (within 1e-4 of max |JAX|)."""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import _torch_parity as tp
from dfmdock_tpu.cli.common import load_model as jax_load_model
from dfmdock_tpu.config import from_yaml as jax_from_yaml
from dfmdock_tpu.data.dataset import complex_to_batch
from dfmdock_tpu.models.dfmdock import DFMDockModel as JaxDFMDock
from dfmdock_tpu_torch.cli.common import load_model
from dfmdock_tpu_torch.config import DFMDockConfig, ModelConfig
from dfmdock_tpu_torch.data.convert import load_npz_complex
from dfmdock_tpu_torch.models import DFMDockModel, ScoreNet
from dfmdock_tpu_torch.params import to_flat

CKPTS = {"mlsb": ("ckpts/db5_demo", 104), "dfmdock": ("ckpts/db5_holdout_dfmdock", 113)}


@functools.lru_cache(maxsize=None)
def _restore(lineage):
    """(checkpoint dir, JAX config, JAX params) of the lineage's orbax step."""
    ckpt = CKPTS[lineage][0]
    cfg = jax_from_yaml(f"{ckpt}/config.yaml")
    return ckpt, cfg, jax_load_model(f"{ckpt}/last", cfg, lineage=lineage)[1]


@pytest.mark.parametrize("lineage", sorted(CKPTS))
def test_npz_equals_orbax_step(lineage):
    ckpt, cfg, params = _restore(lineage)
    n_arrays = CKPTS[lineage][1]
    flat = tp.jax_flat(params)
    with np.load(f"{ckpt}/weights.npz") as z:
        got = {k: z[k] for k in z.files}
    assert len(flat) == n_arrays and set(got) == set(flat)
    for k, v in flat.items():
        assert got[k].dtype == np.float32 and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    # the port loads it strictly (every key matched) and gives it back
    pcfg = DFMDockConfig(model=ModelConfig(**dataclasses.asdict(cfg.model)))
    net = load_model(f"{ckpt}/weights.npz", pcfg, torch.device("cpu"), lineage=lineage)
    assert isinstance(net, {"mlsb": ScoreNet, "dfmdock": DFMDockModel}[lineage])
    back = to_flat(net.state_dict())
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_trained_dfmdock_forward_matches_jax():
    """The trained DFMDock-lineage weights, full width, DB5 1QA9 at its
    native pose, knn-only edges, t = 0.3: every output within 1e-4 of max
    |JAX| on both port routes."""
    ckpt, cfg, params = _restore("dfmdock")
    model = dataclasses.replace(cfg.model, sample_size=0)
    batch = complex_to_batch(load_npz_complex("data/db5_npz/1QA9.npz"))
    out_j = JaxDFMDock(model).apply(params, tp.jax_batch(batch, 0.3), jax.random.PRNGKey(0),
                                    predict=True)
    assert float(np.abs(np.asarray(out_j["f"])).max()) > 0
    pb = tp.port_batch(batch)
    for kernel_path in (False, True):
        pc = ModelConfig(**{**dataclasses.asdict(model), "use_pallas": kernel_path,
                            "edge_table_kernel": kernel_path})
        net = load_model(f"{ckpt}/weights.npz", DFMDockConfig(model=pc), torch.device("cpu"),
                         lineage="dfmdock")
        with torch.no_grad():
            out_p = net(pb, pb["pos"][None], 0.3)
        for k in ("tr_score", "rot_score", "f", "energy", "confidence_logits", "ires_logits"):
            tp.assert_close(out_p[k][0].numpy(), out_j[k], 1e-4, k)
        assert int(out_p["num_clashes"][0]) == int(out_j["num_clashes"])
