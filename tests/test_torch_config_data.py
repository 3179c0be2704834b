"""Port vs JAX: configs and the host data path (npz -> padded batch).

Exact equality throughout: both sides are the same numpy code."""
import dataclasses

import numpy as np
import pytest

import dfmdock_tpu.config as jcfg
import dfmdock_tpu_torch.config as pcfg
from dfmdock_tpu.data.batching import round_up as j_round_up
from dfmdock_tpu.data.dataset import complex_to_batch as j_complex_to_batch
from dfmdock_tpu_torch.data.batching import round_up
from dfmdock_tpu_torch.data.convert import load_npz_complex
from dfmdock_tpu_torch.data.dataset import batch_to_tensors, complex_to_batch


@pytest.mark.parametrize("name", ["default", "fast", "demo_yaml"])
def test_configs_equal(name):
    if name == "default":
        j, p = jcfg.DFMDockConfig(), pcfg.DFMDockConfig()
    elif name == "fast":
        j, p = jcfg.ModelConfig.fast(), pcfg.ModelConfig.fast()
        assert p.edges_per_node == j.edges_per_node == 60
    else:
        j = jcfg.from_yaml("ckpts/db5_demo/config.yaml")
        p = pcfg.from_yaml("ckpts/db5_demo/config.yaml")
    assert dataclasses.asdict(j) == dataclasses.asdict(p)


@pytest.mark.parametrize("cid", ["1AVX", "1JPS", "7CEI"])
def test_batches_equal(cid):
    raw = load_npz_complex(f"data/db5_npz/{cid}.npz")
    j = j_complex_to_batch(raw)
    p = complex_to_batch(raw)
    assert set(j) == set(p)
    for k in j:
        assert np.asarray(j[k]).dtype == np.asarray(p[k]).dtype, k
        np.testing.assert_array_equal(np.asarray(j[k]), np.asarray(p[k]), err_msg=k)
    n = raw["rec_x"].shape[0] + raw["lig_x"].shape[0]
    assert round_up(n) == j_round_up(n) == p["x"].shape[0]
    t = batch_to_tensors(p, "cpu")
    np.testing.assert_array_equal(t["pos"].numpy(), p["pos"])
    assert t["node_mask"].dtype.is_floating_point is False
