"""The helpers of chip_smoke.py's scaling (10b), Heun (10c) and capture
(10d) phases on the CPU: the kernel launches a sample must make
(sample_forwards, expected_launches) against what the port's sampler calls
at each of bench.py's pose counts, with either integrator and on either
route, eagerly and through the graph helper's stand-in capture; the
pose-blocked forward and the plain-version context of the scaling parity.
On the CPU a wrapper runs its plain version and counts nothing, so each
plain version the wrappers fall back to counts here as a launch.
"""
import copy
import importlib.util
import os

import pytest
import torch

from dfmdock_tpu_torch.config import DFMDockConfig, ModelConfig, SamplerConfig
from dfmdock_tpu_torch.data.dataset import batch_to_tensors
from dfmdock_tpu_torch.cli.common import build_sampler, load_model
from dfmdock_tpu_torch.ops import edge_table, energy_head, fused_egcl, select_topk
from dfmdock_tpu_torch.sampler.graph import SampleGraphs
from _graph_stub import StubGraphs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)

POSES = (16,) + cs.SCALING_POSES  # bench.py's POSE_COUNTS
N_PAD, STEPS = 24, 3
TINY = dict(node_dim=32, edge_dim=16, inner_dim=16, depth=3, knn=4, sample_size=4)


@pytest.fixture(autouse=True)
def one_thread():
    """These tests run thousands of tiny ops: one intra-op thread keeps a
    loaded machine (other test processes on every core) from stalling
    each op at its parallel region."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def counted(monkeypatch):
    """The wrappers' CPU fallbacks (their plain versions) count launches."""
    layer_plain = fused_egcl.fused_edge_layer_plain

    def layer(*args, **kwargs):
        coord = args[13] if len(args) > 13 else kwargs.get("coord_params")
        dtype = args[14] if len(args) > 14 else kwargs.get("dtype")
        attr = (("bf16_" if dtype == torch.bfloat16 else "")
                + ("coord_launches" if coord is not None else "launches"))
        setattr(fused_egcl.fused_edge_layer, attr, getattr(fused_egcl.fused_edge_layer, attr) + 1)
        return layer_plain(*args, **kwargs)

    def counting(module, name, wrapper):
        plain = getattr(module, name)

        def count(*args, **kwargs):
            wrapper.launches += 1
            return plain(*args, **kwargs)
        monkeypatch.setattr(module, name, count)

    monkeypatch.setattr(fused_egcl, "fused_edge_layer_plain", layer)
    counting(select_topk, "select_topk_plain", select_topk.select_topk)
    counting(energy_head, "fused_energy_plain", energy_head.fused_energy)
    counting(edge_table, "build_edge_table_plain", edge_table.build_edge_table)
    cs.reset_counts()
    yield
    cs.reset_counts()


def test_expected_launches_at_the_main_path():
    """40 steps: phase 5's dock (41 forwards) and Heun's 2 x 40 + 1."""
    assert cs.sample_forwards(40) == 41 and cs.sample_forwards(40, "heun") == 81
    em = cs.expected_launches(41)
    assert {k: v for k, v in em.items() if v} == {
        "edge_table": 41, "select_topk": 41, "fused_egcl": 205, "fused_egcl_coord": 41,
        "fused_energy": 1}
    heun = cs.expected_launches(81, bf16=True)
    assert {k: v for k, v in heun.items() if v} == {
        "edge_table": 81, "select_topk": 81, "fused_egcl_bf16": 405,
        "fused_egcl_coord_bf16": 81, "fused_energy": 1}
    assert heun["fused_egcl_bf16"] + heun["fused_egcl_coord_bf16"] == 486
    assert set(em) == set(cs.launch_counts())


@pytest.mark.parametrize("integrator", ["em", "heun"])
@pytest.mark.parametrize("poses", POSES)
def test_sample_launches_match_the_helpers(counted, poses, integrator):
    """A sample of `poses` poses on each kernel route (tiny widths, the
    plain versions standing in for the kernels) makes exactly
    expected_launches(sample_forwards(...)), whatever the pose count."""
    batch = batch_to_tensors(cs.synthetic_complex(N_PAD, seed=poses), torch.device("cpu"))
    scfg = SamplerConfig(num_steps=STEPS, ode=integrator == "heun", integrator=integrator)
    for bf16 in (False, True):
        mcfg = ModelConfig.fast(compute_dtype="bfloat16" if bf16 else "float32", **TINY)
        cfg = DFMDockConfig(model=mcfg, sampler=scfg)
        sampler = build_sampler(load_model(None, cfg, torch.device("cpu")), cfg)
        cs.reset_counts()
        out = sampler.sample(batch, poses, torch.Generator().manual_seed(poses))
        assert out["pos"].shape[0] == poses and torch.isfinite(out["energy"]).all()
        want = cs.expected_launches(cs.sample_forwards(STEPS, integrator), bf16, mcfg.depth)
        assert cs.launch_counts() == want, (bf16, cs.launch_counts())


@pytest.mark.parametrize("integrator", ["em", "heun"])
def test_captured_sample_launches_match_the_helpers(counted, integrator):
    """Through the samplers' graph helper (the CPU stand-in for the
    capture) the wrappers count where they are called: the first sample's
    warm-up (sample_forwards(1, ...)) and capture (expected_launches(
    sample_forwards(...))), and nothing in a replay; the helper records the
    warm-up's, the capture's and the two replays' launches, which
    chip_smoke.run_path holds a run's trace against."""
    batch = batch_to_tensors(cs.synthetic_complex(N_PAD, seed=3), torch.device("cpu"))
    scfg = SamplerConfig(num_steps=STEPS, ode=integrator == "heun", integrator=integrator)
    mcfg = ModelConfig.fast(compute_dtype="float32", **TINY)
    cfg = DFMDockConfig(model=mcfg, sampler=scfg)
    sampler = build_sampler(load_model(None, cfg, torch.device("cpu")), cfg)
    sampler.graphs = SampleGraphs(StubGraphs())
    want = cs.expected_launches(cs.sample_forwards(STEPS, integrator), False, mcfg.depth)
    warm = cs.expected_launches(cs.sample_forwards(1, integrator), False, mcfg.depth)
    gen = torch.Generator().manual_seed(3)
    for first in (True, False):
        cs.reset_counts()
        sampler.sample(batch, 4, gen)
        assert cs.launch_counts() == ({k: warm[k] + v for k, v in want.items()} if first
                                      else dict.fromkeys(want, 0))
    stats = sampler.graphs.stats
    assert (stats.captures, stats.replays) == (1, 2)
    nonzero = lambda d: {k: v for k, v in d.items() if v}
    assert stats.warmup_launches == nonzero(warm)
    assert stats.captured_launches == nonzero(want)
    assert stats.replayed_launches == nonzero({k: 2 * v for k, v in want.items()})


def test_blocked_forward_and_plain_kernels(counted):
    """The pose-blocked forward of the plain path equals one forward of all
    the poses, and inside plain_kernels() the models call the plain
    versions, launching nothing; the sites come back afterwards."""
    cpu = torch.device("cpu")
    batch = batch_to_tensors(cs.synthetic_complex(N_PAD, seed=3), cpu)
    net = load_model(None, DFMDockConfig(model=ModelConfig.fast(compute_dtype="float32", **TINY)),
                     cpu)
    pos = batch["pos"][None].expand(5, -1, -1, -1).contiguous()
    pos = pos + torch.randn(pos.shape, generator=torch.Generator().manual_seed(0))
    edges = cs.select_edges(cs.pairwise_ca_dist(pos), batch["node_mask"], TINY["knn"],
                            TINY["sample_size"], generator=torch.Generator().manual_seed(1))
    sites = [getattr(module, attr) for _, module, attr, _, _ in cs.KERNEL_SITES]
    with torch.no_grad():
        whole = net(batch, pos, 0.5, edges=edges)
    assert cs.launch_counts()["fused_egcl_coord"] == 1
    cs.reset_counts()
    with cs.plain_kernels():
        blocks = cs.blocked_forward(net, batch, pos, 0.5, edges, block=2)
    assert not any(cs.launch_counts().values())
    assert [getattr(module, attr) for _, module, attr, _, _ in cs.KERNEL_SITES] == sites
    assert set(blocks) == set(whole)
    for k, v in whole.items():
        assert blocks[k].shape == v.shape, k
        torch.testing.assert_close(blocks[k], v, rtol=1e-5, atol=1e-6, msg=k)


def test_scaling_parity_holds_an_output_to_its_precision(monkeypatch):
    """precision_floors' float32 floor: the float32 plain path's distance
    from its float64 evaluation, small and not zero.  An output beyond its
    route's bound (F32_PARITY_REL; PARITY_TOL on the bf16 route) passes
    within BF16_ROUTE_FACTOR times its floor and fails beyond it."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    cpu = torch.device("cpu")
    batch = batch_to_tensors(cs.synthetic_complex(N_PAD, seed=3), cpu)
    batch64 = {k: v.double() if v.is_floating_point() else v for k, v in batch.items()}
    net = load_model(None, DFMDockConfig(model=ModelConfig.fast(compute_dtype="float32", **TINY)),
                     cpu)
    pos = batch["pos"][None].expand(2, -1, -1, -1).contiguous()
    pos = pos + torch.randn(pos.shape, generator=torch.Generator().manual_seed(0))
    edges = cs.select_edges(cs.pairwise_ca_dist(pos), batch["node_mask"], TINY["knn"],
                            TINY["sample_size"], generator=torch.Generator().manual_seed(1))
    floor = cs.precision_floors(copy.deepcopy(net).double(), None, batch, batch64, pos,
                                edges)["f32"]
    with torch.no_grad():
        o_p, o_64 = floor(net(batch, pos, cs.SCALING_T, edges=edges))
    assert o_64["rot_score"].dtype == torch.float64
    own = cs.max_errs(o_p["rot_score"].double(), o_64["rot_score"])[1]
    assert 0 < own < 1e-2
    assert cs.scaling_parity("plain", net, batch, pos, edges, True, floor) == []
    # the rule, on a floor in rot_score of 0.005 (f32: between F32_PARITY_REL
    # and PARITY_TOL, which the float32 route must meet) and 0.05 (bf16)
    parity_errors = cs.parity_errors
    for f32, own in ((True, 0.005), (False, 0.05)):
        fixed = lambda o_p, own=own: ({**o_p, "rot_score": o_p["rot_score"] * (1 + own)}, o_p)
        for factor, bad in ((1.5, []), (2.5, ["rot_score"])):
            def forced(outputs, o_k, o_p, f32=True, r_err=factor * own):
                errs = parity_errors(outputs, o_k, o_p, f32)
                errs["rot_score"] = (0.0, r_err, r_err < cs.PARITY_TOL["rot_score"])
                return errs
            monkeypatch.setattr(cs, "parity_errors", forced)
            assert cs.scaling_parity("forced", net, batch, pos, edges, f32, fixed) == bad
