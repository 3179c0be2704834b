"""The samplers' one-graph form (sampler/graph.py) on the CPU.

The capture itself needs the card; here a stand-in backend
(_graph_stub.StubGraphs) "captures" by running the body once without
moving the generator and "replays" by running it again into the recorded
outputs, its Python launch counting undone, as a CUDA graph's replay
counts nothing.  So these tests hold the
helper's own logic: the body each sampler hands it, the generator state
copied in and out, the cache key (one capture per bucket for the DFMDock
lineage too), the launch accounting, the cloned outputs, the
prepared-weight cache's refusal under capture, and the ranking draws'
generators.  The same inputs go through the JAX samplers at the
tolerances of test_torch_sampler.py::test_ode_trajectory_matches_jax and
test_torch_picard.py::test_matches_jax_picard.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
from _graph_stub import StubGraphs
from dfmdock_tpu.config import R3Config as JR3Config, SamplerConfig as JSamplerConfig
from dfmdock_tpu.config import SO3Config as JSO3Config
from dfmdock_tpu.diffusion import R3Diffuser as JR3, SO3Diffuser as JSO3
from dfmdock_tpu.models import ScoreNet as JaxScoreNet
from dfmdock_tpu.sampler import EMSampler as JaxEMSampler, PicardSampler as JaxPicard
from dfmdock_tpu_torch.cli import sweep
from dfmdock_tpu_torch.config import R3Config, SamplerConfig, SO3Config
from dfmdock_tpu_torch.data.dataset import batch_to_tensors, complex_to_batch
from dfmdock_tpu_torch.diffusion import R3Diffuser, SO3Diffuser
from dfmdock_tpu_torch.models import DFMDockModel, ScoreNet
from dfmdock_tpu_torch.models.egnn import fused_weights
from dfmdock_tpu_torch.models.modules import time_tensor
from dfmdock_tpu_torch.ops import launch_counts
from dfmdock_tpu_torch.ops.edge_table import edge_bins
from dfmdock_tpu_torch.ops.select_topk import select_topk
from dfmdock_tpu_torch.sampler import EMSampler, PicardSampler
from dfmdock_tpu_torch.sampler import graph as graph_mod
from dfmdock_tpu_torch.sampler.em import step_schedule
from dfmdock_tpu_torch.sampler.graph import SampleGraphs

STEPS = 4
SHIFT, ROT = [4.0, -3.0, 2.0], [0.2, 0.1, -0.3]
# the JAX tests' sampler settings: ODE, R3 max_sigma 1 A, knn-only edges
SCFG = {"em": dict(num_steps=STEPS, ode=True),
        "heun": dict(num_steps=STEPS, ode=True, integrator="heun", use_clash_force=True),
        "picard": dict(num_steps=STEPS, ode=True, init_tr_sigma=4.0)}


@pytest.fixture(autouse=True)
def one_thread():
    """These tests run thousands of tiny ops: one intra-op thread keeps a
    loaded machine (other test processes on every core) from stalling
    each op at its parallel region."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _sampler(kind, net, num_iters=STEPS, max_sigma=1.0, **scfg):
    r3, so3 = R3Diffuser(R3Config(max_sigma=max_sigma)), SO3Diffuser(SO3Config())
    cfg = SamplerConfig(**{**SCFG[kind], **scfg})
    if kind == "picard":
        return PicardSampler(net, r3, so3, cfg, num_iters)
    return EMSampler(net, r3, so3, cfg)


def _stubbed(sampler):
    sampler.graphs = SampleGraphs(StubGraphs())
    return sampler


def _init(b):
    init_pos = b["pos"].copy()
    init_pos[40:64] += np.float32(SHIFT)
    return init_pos, np.float32([SHIFT]), np.float32([ROT])


def _equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.fixture(scope="module")
def jax_side():
    """The JAX samplers' outputs (EM and Picard, jitted) from the JAX tests'
    shared start pose."""
    jc, pc = tp.configs(sample_size=0)
    params = jax.jit(JaxScoreNet(jc).init)(jax.random.PRNGKey(0))
    b = tp.padded(40, 24, seed=9)
    init = _init(b)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jinit = tuple(map(jnp.asarray, init))
    r3, so3 = JR3(JR3Config(max_sigma=1.0)), JSO3(JSO3Config())
    jsam = JaxEMSampler(JaxScoreNet(jc), r3, so3, JSamplerConfig(**SCFG["em"]))
    jpic = JaxPicard(JaxScoreNet(jc), r3, so3, JSamplerConfig(**SCFG["picard"]),
                     num_iters=STEPS)
    out = {"em": jax.jit(lambda: jsam.sample_one(params, jb, jax.random.PRNGKey(3),
                                                 init=jinit, record_trajectory=True))(),
           "picard": jax.jit(lambda: jpic.sample_one(params, jb, jax.random.PRNGKey(3),
                                                     init=jinit))()}
    return pc, params, b, init, out


@pytest.mark.parametrize("kind", ["em", "heun", "picard"])
def test_body_matches_eager_and_jax(jax_side, kind):
    """The body called eagerly, the sampler with capture=False and the
    stand-in's replay give the same outputs bit for bit; EM and Picard
    within 1e-4 of max |JAX| (the JAX tests' tolerance; Heun with the clash
    force is held to JAX by test_heun_trajectory_matches_jax on the same
    body)."""
    pc, params, b, init, out_j = jax_side
    sampler = _sampler(kind, tp.port_net(pc, params))
    pb = tp.port_batch(b)
    init_p = tuple(torch.from_numpy(x)[None] for x in init)
    gen = lambda: torch.Generator().manual_seed(0)
    trajectory = kind != "picard"
    eager = sampler.sample(pb, 1, gen(), init=init_p, record_trajectory=trajectory,
                           capture=False)
    inputs = {"batch": dict(pb), "init": init_p}
    if kind == "picard":
        inputs["t_all"] = torch.tensor(step_schedule(sampler.cfg)[0])
    else:
        inputs["noise"] = None
    body = sampler._body(inputs, num_samples=1, generator=gen(),
                         record_trajectory=trajectory, static=False)
    _equal(body, eager)
    _equal(_stubbed(sampler).sample(pb, 1, gen(), init=init_p,
                                    record_trajectory=trajectory), eager)
    assert sampler.graphs.stats.captures == 1
    if kind == "heun":
        return
    keys = ("pos", "tr_update", "tr_score", "rot_score", "energy")
    keys += ("rot_update",) if kind == "picard" else ("trajectory",)
    for k in keys:
        tp.assert_close(eager[k][0].numpy(), out_j[kind][k], 1e-4, k)


@pytest.mark.parametrize("kind,model", [("em", ScoreNet), ("em", DFMDockModel),
                                        ("heun", ScoreNet), ("picard", ScoreNet)])
def test_replay_draws_as_eager(kind, model):
    """With every draw from the generator (start poses, sampled edges, the
    SDE noise): the replay equals the eager sample from the same generator
    state bit for bit, leaves the generator where the eager sample does,
    and a second replay draws other noise."""
    _, pc = tp.configs(sample_size=8)
    net = model(dataclasses.replace(pc, knn=6)).init_weights(
        torch.Generator().manual_seed(1)).eval()
    scfg = {"ode": False} if kind == "em" else {}
    sampler = _sampler(kind, net, num_iters=2, max_sigma=5.0, **scfg)
    pb = tp.port_batch(tp.padded(30, 20, seed=4))
    g_eager, g_graph = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
    _stubbed(sampler)  # the stand-in captures on the CPU: eager samples there are its device's
    eager = [sampler.sample(pb, 2, g_eager, capture=False) for _ in range(2)]
    replayed = [sampler.sample(pb, 2, g_graph) for _ in range(2)]
    for a, b in zip(replayed, eager):
        _equal(a, b)
    assert torch.equal(g_graph.get_state(), g_eager.get_state())
    assert not torch.equal(replayed[0]["pos"], replayed[1]["pos"])
    assert sampler.graphs.stats.captures == 1 and sampler.graphs.stats.replays == 2


def test_capture_true_on_cpu_raises():
    _, pc = tp.configs(sample_size=0)
    sampler = _sampler("em", ScoreNet(pc).init_weights(torch.Generator().manual_seed(0)))
    with pytest.raises(ValueError, match="capture=True"):
        sampler.sample(tp.port_batch(tp.padded(10, 6)), 1, torch.Generator(), capture=True)


def test_cache_key():
    """One capture per (N, P, record_trajectory, injected init or noise,
    weights); a repeat replays, from another generator too (its state is
    copied in), and an in-place weight update drops the graphs and captures
    again."""
    _, pc = tp.configs(sample_size=0)
    net = ScoreNet(dataclasses.replace(pc, knn=4)).init_weights(
        torch.Generator().manual_seed(0)).eval()
    sampler = _stubbed(_sampler("em", net, num_steps=2, ode=False))
    gen = torch.Generator().manual_seed(0)
    b16, b24 = (tp.port_batch(tp.padded(10, 6, pad_to=16)),
                tp.port_batch(tp.padded(14, 10, pad_to=24)))
    pos0 = b16["pos"][None].expand(2, -1, -1, -1).clone()
    init = (pos0, torch.zeros(2, 1, 3), torch.zeros(2, 1, 3))
    noise = (torch.zeros(2, 2, 1, 3), torch.ones(2, 2, 1, 3))
    stats = sampler.graphs.stats
    calls = [(b16, 2, {}, True), (b16, 2, {}, False), (b24, 2, {}, True),
             (b16, 3, {}, True), (b16, 2, {"record_trajectory": True}, True),
             (b16, 2, {"init": init}, True), (b16, 2, {"noise": noise}, True),
             (b16, 2, {"init": init, "noise": noise}, True),
             (b16, 2, {"noise": (noise[1], noise[0])}, False)]
    for batch, p, kw, new in calls:
        before = stats.captures
        sampler.sample(batch, p, gen, **kw)
        assert stats.captures == before + new, (batch["pos"].shape, p, kw)
    assert len(sampler.graphs.graphs) == 7
    sampler.sample(b16, 2, torch.Generator().manual_seed(0))  # another generator
    assert stats.captures == 7
    with torch.no_grad():
        net.egnn[0].edge_mlp["l1"].weight.mul_(1.0)  # in place: a new _version
    sampler.sample(b16, 2, gen)
    assert stats.captures == 8 and len(sampler.graphs.graphs) == 1
    sampler.sample(b16, 2, gen)
    assert stats.captures == 8 and stats.replays == len(calls) + 3


def test_launches_count_executions(monkeypatch):
    """The accounting counts executions as replays x the launches a graph
    recorded: a graph that records 3 select_topk and 1 edge_bins launches,
    replayed 4 times, ran 12 and 4; its warm-up's launches are kept apart.
    The wrappers' own counts move where a wrapper is called (the warm-up,
    the capture) and never in a replay."""
    monkeypatch.setattr(select_topk, "launches", 0)
    monkeypatch.setattr(edge_bins, "launches", 0)

    def body(inputs, generator, warmup=False):
        select_topk.launches += 1 if warmup else 3
        edge_bins.launches += 1
        return {"y": inputs["x"] * 2.0}

    graphs = SampleGraphs(StubGraphs())
    graph_mod.reset_totals()
    counts = launch_counts()
    x, module, gen = torch.arange(3.0), torch.nn.Linear(1, 1), torch.Generator()
    outs = [graphs.run(module, "k", {"x": x + i}, body, gen) for i in range(4)]
    got = {k: v - counts[k] for k, v in launch_counts().items() if v != counts[k]}
    assert got == {"select_topk": 4, "edge_bins": 2}  # the warm-up's and the capture's
    assert graphs.stats.replayed_launches == {"select_topk": 12, "edge_bins": 4}
    assert graphs.stats.captured_launches == {"select_topk": 3, "edge_bins": 1}
    assert graphs.stats.warmup_launches == {"select_topk": 1, "edge_bins": 1}
    assert (graphs.stats.captures, graphs.stats.replays) == (1, 4)
    assert graph_mod.totals().replays == 4
    # outputs are clones: a later replay leaves what a caller holds
    assert [o["y"].tolist() for o in outs] == [[2.0 * (j + i) for j in range(3)]
                                               for i in range(4)]


def test_prepared_weights_refused_under_capture(monkeypatch):
    """The fused route's weight cache is never built while a stream is
    capturing (its tensors would be computed by a replay only)."""
    _, pc = tp.configs()
    layer = ScoreNet(pc).init_weights(torch.Generator().manual_seed(0)).egnn[0]
    spatial, positional = torch.randn(100, pc.edge_dim), torch.randn(66, pc.edge_dim)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with torch.no_grad(), pytest.raises(RuntimeError, match="warm-up"):
        fused_weights(layer, spatial, positional)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    with torch.no_grad():
        w = fused_weights(layer, spatial, positional)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with torch.no_grad():
        assert fused_weights(layer, spatial, positional) is w  # built: read under capture


def test_ranking_draws_replayed():
    """The ranking draws through one graph per (P, N, t) of the caller's
    SampleGraphs: each replay draws from the draw's own seeded generator, so
    the scores equal the eager draws and those of a fresh generator per
    draw; two t's capture twice, a repeat none."""
    _, pc = tp.configs(sample_size=8)
    net = ScoreNet(dataclasses.replace(pc, knn=6)).init_weights(
        torch.Generator().manual_seed(2)).eval()
    rec_x, lig_x, rec_pos, lig_pos = tp.make_complex(30, 20, pc.lm_embed_dim - 21, seed=4)
    raw = {"rec_x": rec_x, "lig_x": lig_x, "rec_pos": rec_pos, "lig_pos": lig_pos,
           "rec_seq": "A" * 30, "lig_seq": "G" * 20}
    batch = batch_to_tensors(complex_to_batch(raw), "cpu")
    pos = (batch["pos"][None] + torch.randn(3, 1, 1, 3, generator=torch.Generator()
                                            .manual_seed(0))).numpy()
    cpu = torch.device("cpu")
    eager = sweep._multi_draw_scores(net, raw, pos, None, 3, 5, cpu, 0.3, capture=False)
    stub = SampleGraphs(StubGraphs())
    for t, new in ((0.3, 1), (0.6, 1), (0.3, 0)):
        before = stub.stats.captures
        got = sweep._multi_draw_scores(net, raw, pos, None, 3, 5, cpu, t, graphs=stub)
        assert stub.stats.captures == before + new
        if t == 0.3:
            for k in eager:
                np.testing.assert_array_equal(got[k], eager[k])
    assert stub.stats.replays == 9
    # the draws of a fresh generator per draw, as before the graphs
    batch["h0"] = net.embed_nodes(batch["x"])
    with torch.no_grad():
        energy = sum(net(batch, torch.from_numpy(pos), 0.3, generator=torch.Generator()
                         .manual_seed(sweep.DRAW_SEED_BASE + 5 * sweep.DRAW_SEED_STRIDE + k))
                     ["energy"].double().numpy() for k in range(3)) / 3
    np.testing.assert_array_equal(eager["energy"], energy)


def test_time_tensor_fills_as_the_copy():
    for t in (1.0, 0.7431, 1e-3, 0.123456789):
        assert torch.equal(time_tensor(t, "cpu"), torch.as_tensor(t, dtype=torch.float32))
    ts = torch.tensor([0.5, 0.25])
    assert torch.equal(time_tensor(ts, "cpu"), ts)


def test_dfmdock_captures_once_a_bucket():
    """The DFMDock lineage's pair heads take the padded N's shapes (the
    static pair rows, made inside the sample): two complexes of other
    receptor and ligand sizes in one bucket replay one graph, each bit-equal
    to its eager sample."""
    _, pc = tp.configs(sample_size=8)
    net = DFMDockModel(dataclasses.replace(pc, knn=6)).init_weights(
        torch.Generator().manual_seed(1)).eval()
    sampler = _sampler("em", net, num_steps=2, ode=False, max_sigma=5.0)
    batches = [tp.port_batch(tp.padded(r, l, seed=s, pad_to=64))
               for r, l, s in ((30, 20, 4), (22, 35, 5))]
    _stubbed(sampler)
    eager = [sampler.sample(b, 2, torch.Generator().manual_seed(3), capture=False)
             for b in batches]
    for b, want in zip(batches, eager):
        _equal(sampler.sample(b, 2, torch.Generator().manual_seed(3)), want)
    assert (sampler.graphs.stats.captures, sampler.graphs.stats.replays) == (1, 2)
