"""scripts/dfmdock_witness.py's CPU-draw sides make the `port` side's own
draws: with the CPU as their device and the eager route, a sweep of two
complexes (the generator running on from one to the next) gives the `port`
side's rows bit for bit.  This is what lets the card's run with the CPU
generator's draws be compared with the CPU run pose for pose (ROADMAP F4).
The side with the JAX record's draws (scripts/export_jax_draws.py's file)
runs on the CPU at a small size.
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "scripts"))
import dfmdock_witness as witness  # noqa: E402


def test_cpu_draws_side_repeats_the_port_sides_draws():
    ids, seed, poses, steps = ["1ZHI", "2SNI"], 6, 2, 1
    want = witness.port_side(ids, seed, poses, steps, "port")
    got = witness.port_cpu_draws_side(ids, seed, poses, steps, exact=True, device="cpu")
    assert sorted(got) == sorted(want) == sorted(ids)
    for cid in ids:
        np.testing.assert_array_equal(got[cid], want[cid], err_msg=cid)


def test_jax_draws_side_runs_on_the_cpu():
    """One pose x one step of 1ZHI at seed 5 on the CPU (the kernel route's
    plain versions): one finite row."""
    got = witness.jax_draws_side(["1ZHI"], 5, 1, 1, device="cpu")
    assert sorted(got) == ["1ZHI"] and got["1ZHI"].shape == (1, 2)
    assert np.isfinite(got["1ZHI"]).all()


def test_cpu_draws_side_runs_eagerly_where_samples_capture(monkeypatch):
    """Where samples capture (here the CPU stand-in of the capture), the
    CPU-draw side still runs its samples eagerly, as its net draws in
    Python each forward, and gives finite rows; capturing such a net
    raises, naming capture=False."""
    import pytest
    import torch

    import _torch_parity as tp
    from _graph_stub import StubGraphs
    from dfmdock_tpu_torch.config import R3Config, SamplerConfig, SO3Config
    from dfmdock_tpu_torch.diffusion import R3Diffuser, SO3Diffuser
    from dfmdock_tpu_torch.models import DFMDockModel
    from dfmdock_tpu_torch.sampler import EMSampler, graph

    monkeypatch.setattr(graph, "CudaGraphs", StubGraphs)
    got = witness.port_cpu_draws_side(["1ZHI"], 6, 1, 1, exact=True, device="cpu")
    assert sorted(got) == ["1ZHI"] and got["1ZHI"].shape == (1, 2)
    assert np.isfinite(got["1ZHI"]).all()
    _, pc = tp.configs(sample_size=8)
    net = DFMDockModel(pc).init_weights(torch.Generator().manual_seed(0)).eval()
    draws = witness.CPUDraws(net, torch.Generator().manual_seed(0), 1)
    sampler = EMSampler(draws, R3Diffuser(R3Config()), SO3Diffuser(SO3Config()),
                        SamplerConfig(num_steps=1))
    with pytest.raises(TypeError, match="capture=False"):
        sampler.sample(tp.port_batch(tp.padded(20, 12, pad_to=32)), 1,
                       torch.Generator().manual_seed(0))
