"""The training step in its captured form (train/pool.PoolStep) and what it
needs of the model, on the CPU at small width (crop 64), against the JAX
package where the two can be held equal.

- the embedding tables' lookups (features/sixd.table_rows): the forward is
  the indexed form's bit for bit; the tables' gradients (a [V, M] x [M, E]
  product in place of the indexed form's sorted scatter) within rel 1e-5 of
  each table's largest against JAX's `w[idx]` (an exact f32 scatter-add:
  the two sum up to M / V rows of a table row in another order), and no
  `index_put_` in a training step's backward;
- the DFMDock pair heads over the row lists of models/egnn_net.pair_rows,
  their count a tensor: every output and gradient equals the form that
  picked the rows inside each forward, bit for bit; the predict forward,
  with the lists made per forward or hoisted into the batch, against JAX's
  EGNNNet (outputs rel 1e-4, gradients rel 1e-3 of each array's largest,
  JAX's gathers exact, as tests/test_torch_losses.py); a dock makes the
  lists once, not per forward;
- PoolStep run eagerly equals train_step on the rows the permutation picks,
  step by step, on both lineages at float32 and bfloat16: the weights after
  each step, the metrics, and the generator's state after, bit for bit;
- on a card (marked `cuda`, skipped here): two epochs of two steps, with a
  pool refresh between, replayed from one captured graph against as many
  eager steps from one generator seed.

JAX is imported inside the CPU tests, so the `cuda` case runs on a machine
without it: python -m pytest --noconftest -m cuda tests/test_torch_train_graph.py
"""
from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from dfmdock_tpu_torch.config import ExperimentConfig, ModelConfig, R3Config, SO3Config
from dfmdock_tpu_torch.diffusion import R3Diffuser, SO3Diffuser
from dfmdock_tpu_torch.features.sixd import spatial_embed_from_bins, table_rows
from dfmdock_tpu_torch.models import EGNNNet, ScoreNet
from dfmdock_tpu_torch.models import egnn_net
from dfmdock_tpu_torch.models.egnn_net import ROW_CHUNK, pair_rows
from dfmdock_tpu_torch.train.dfmdock_losses import dfmdock_loss_fn
from dfmdock_tpu_torch.train.losses import loss_fn as mlsb_loss_fn
from dfmdock_tpu_torch.train.pool import PoolStep, train_step, upload
from dfmdock_tpu_torch.train.trainer import make_optimizer

TABLE_REL = 1e-5
FWD_REL = 1e-4
GRAD_REL = 1e-3
CROP = 64
SMALL = dict(lm_embed_dim=32, node_dim=32, edge_dim=16, inner_dim=16, depth=2)
# the training CLI's flags of chip_smoke's 9g (mlsb) and 9h (DFMDock)
LOSSES = {"mlsb": (ScoreNet, mlsb_loss_fn, dict(grad_energy=True, use_contrastive_loss=True)),
          "dfmdock": (EGNNNet, dfmdock_loss_fn, dict(grad_energy=True))}


def bins(shape, seed):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randint(0, n, shape).astype(np.int32))
            for n in (40, 24, 24, 12, 66)]


@pytest.mark.parametrize("table", ["spatial", "positional"])
def test_table_rows_forward_and_gradient(table):
    """table_rows' values equal the indexed form's bit for bit, and its
    gradient JAX's (jnp indexing: an f32 scatter-add) within TABLE_REL."""
    import jax
    import jax.numpy as jnp

    from dfmdock_tpu.features.sixd import spatial_embed_from_bins as jax_spatial

    rng = np.random.RandomState(3)
    db, ob, tb, pb, rp = bins((2, 48, 30), 4)
    rows = 100 if table == "spatial" else 66
    w_np = rng.randn(rows, 16).astype(np.float32)
    cot = rng.randn(2, 48, 30, 16).astype(np.float32)
    w = torch.from_numpy(w_np).requires_grad_(True)
    if table == "spatial":
        out = spatial_embed_from_bins(w, db, ob, tb, pb)
        ref = (w[db.long()] + w[40 + ob.long()] + w[64 + tb.long()] + w[88 + pb.long()])
        fwd = lambda v: jax_spatial(v, *(jnp.asarray(b.numpy()) for b in (db, ob, tb, pb)))
    else:
        out, ref = table_rows(w, rp), w[rp.long()]
        fwd = lambda v: v[jnp.asarray(rp.numpy())]
    assert torch.equal(out, ref)
    (g,) = torch.autograd.grad(out, w, torch.from_numpy(cot))
    want = np.asarray(jax.grad(lambda v: (fwd(v) * cot).sum())(jnp.asarray(w_np)))
    assert np.abs(g.numpy() - want).max() <= TABLE_REL * np.abs(want).max()


@pytest.fixture(scope="module")
def diffusers():
    return R3Diffuser(R3Config()), SO3Diffuser(SO3Config())


def small_pool(rows, seed=7):
    """`rows` padded complexes of different sizes at crop 64, as a device
    pool on the CPU (the training CLI's MODEL_KEYS)."""
    from _torch_parity import padded

    made = [padded(30 + 3 * i, 20 + 2 * i, seed=seed + i, pad_to=CROP) for i in range(rows)]
    return upload({k: np.stack([b[k] for b in made]) for k in made[0]}, torch.device("cpu"))


def small_net(lineage, dtype="float32", seed=0):
    cls, _, _ = LOSSES[lineage]
    cfg = ModelConfig(**SMALL, dropout=0.1, knn=12, sample_size=16, compute_dtype=dtype)
    return cls(cfg).init_weights(torch.Generator().manual_seed(seed))


def test_training_step_has_no_indexed_backward(diffusers):
    """A training step's backward adds the tables' rows by product, not by
    index_put_ (the indexed form's backward, `indexing_backward_kernel` on
    the card)."""
    from torch.profiler import ProfilerActivity, profile

    net = small_net("dfmdock")
    _, loss_fn, exp_kw = LOSSES["dfmdock"]
    pool = small_pool(1)
    batch = {k: v[0] for k, v in pool.items()}
    loss, _ = loss_fn(net, *diffusers, batch, torch.Generator().manual_seed(0),
                      ExperimentConfig(**exp_kw))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        loss.backward()
    names = {e.key for e in prof.key_averages()}
    assert not any("index_put" in k for k in names), sorted(k for k in names if "index" in k)
    assert net.spatial_embed.weight.grad.abs().max() > 0
    assert net.positional_embed.weight.grad.abs().max() > 0


def pair_heads_nonzero(net, h, ca, dist, rec, lig, scores_only):
    """The pair heads as the predict path computed them before the row
    lists came from the batch: the receptor and ligand rows picked by
    torch.nonzero inside each forward, the confidence count a float."""
    rec_idx = torch.nonzero(rec).squeeze(-1)
    lig_idx = torch.nonzero(lig).squeeze(-1)
    p, n = h.shape[:2]
    h_l, ca_l = h[:, lig_idx], ca[:, lig_idx]
    d_rl = dist[:, rec_idx][:, :, lig_idx]
    heads = [net.to_force] + ([] if scores_only else [net.to_energy, net.to_confidence])
    parts = [head.split(h[:, rec_idx], h_l) for head in heads]
    f_acc = h.new_zeros(p, lig_idx.numel(), 3)
    e_num, e_den, c_num = h.new_zeros(p), h.new_zeros(p), h.new_zeros(p)
    for i0 in range(0, rec_idx.numel(), ROW_CHUNK):
        rows = slice(i0, i0 + ROW_CHUNK)
        d_c = d_rl[:, rows]
        pre = lambda k: parts[k][0][:, rows, None, :] + parts[k][1][:, None, :, :]
        fs = net.to_force(pre(0), d_c)
        vec = ca[:, rec_idx[rows], None, :] - ca_l[:, None, :, :]
        unit = vec / torch.sqrt((vec * vec).sum(-1, keepdim=True).clamp(min=1e-12))
        f_acc = f_acc + (unit * fs).sum(1)
        if not scores_only:
            em = (d_c < net.cfg.cut_off).to(h.dtype)
            e_num = e_num + (net.to_energy(pre(1), d_c)[..., 0] * em).sum((-2, -1))
            e_den = e_den + em.sum((-2, -1))
            c_num = c_num + net.to_confidence(pre(2), d_c)[..., 0].sum((-2, -1))
    f = h.new_zeros(p, n, 3)
    f[:, lig_idx] = f_acc
    out = {"f": f}
    if not scores_only:
        out["energy"] = (e_num, e_den)
        out["confidence"] = (c_num, torch.tensor(float(rec_idx.numel() * lig_idx.numel())))
        out["num_clashes"] = (d_rl <= 3.0).sum((-2, -1)).to(torch.int32)
    return out


def flat_outputs(out):
    return {k: v for k, v in out.items() if not isinstance(v, tuple)} | {
        f"{k}{i}": x for k, v in out.items() if isinstance(v, tuple) for i, x in enumerate(v)}


@pytest.mark.parametrize("scores_only", [False, True])
def test_pair_heads_match_nonzero_form(scores_only):
    """The pair heads over pair_rows' lists with the pairs' count as a
    tensor: every output and its gradients (h, ca, the heads' weights)
    bit-equal to the form that ran torch.nonzero in each forward."""
    from _torch_parity import padded

    net = small_net("dfmdock", seed=2)
    b = padded(37, 21, seed=9, pad_to=CROP)
    rng = np.random.RandomState(1)
    h0 = torch.from_numpy(rng.randn(2, CROP, SMALL["node_dim"]).astype(np.float32))
    ca = torch.from_numpy(np.stack([b["pos"][:, 1], b["pos"][:, 1] * 0.9]))
    dist = torch.sqrt(((ca[:, :, None] - ca[:, None]) ** 2).sum(-1).clamp(min=1e-12))
    batch = {k: torch.from_numpy(b[k]) for k in ("node_mask", "lig_mask")}
    valid = batch["node_mask"].float()
    lig = batch["lig_mask"] * valid
    rec = (1.0 - batch["lig_mask"]) * valid
    rows = pair_rows(batch)
    assert [r.numel() for r in rows] == [37, 21]
    weights = [p for n_, p in net.named_parameters() if n_.startswith("to_")]

    def run(fn):
        h = h0.clone().requires_grad_(True)
        c = ca.clone().requires_grad_(True)
        outs = flat_outputs(fn(h, c))
        loss = sum((v.float() * torch.from_numpy(
            np.random.RandomState(len(k)).randn(*v.shape).astype(np.float32))).sum()
            for k, v in outs.items() if v.dtype.is_floating_point and v.requires_grad)
        grads = torch.autograd.grad(loss, [h, c] + weights, allow_unused=True)
        return outs, [torch.zeros(1) if g is None else g for g in grads]

    ref, g_ref = run(lambda h, c: pair_heads_nonzero(net, h, c, dist, rec > 0, lig > 0,
                                                     scores_only))
    got, g_got = run(lambda h, c: net._pair_heads(h, c, dist, *rows, rec.sum() * lig.sum(),
                                                  scores_only))
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert torch.equal(got[k], ref[k].to(got[k].dtype)), k
    for a, b_ in zip(g_got, g_ref):
        assert torch.equal(a, b_)


def test_dock_makes_pair_rows_once(monkeypatch):
    """A dock of the DFMDock net makes the pair heads' row lists once (the
    net's `prepare` at the start of the sample, as batch['pair_rows']), not
    in each of its forwards."""
    from _torch_parity import padded

    from dfmdock_tpu_torch.config import SamplerConfig
    from dfmdock_tpu_torch.sampler import em

    calls = {"sampler": 0, "forward": 0}
    rows = egnn_net.pair_rows
    where = ["sampler"]

    def counting(batch, static=False):
        calls[where[0]] += 1
        return rows(batch, static)

    monkeypatch.setattr(egnn_net, "pair_rows", counting)
    net = small_net("dfmdock", seed=3).eval()
    b = padded(30, 20, seed=4, pad_to=CROP)
    batch = {k: torch.from_numpy(b[k]) for k in ("x", "pos", "node_mask", "lig_mask",
                                                  "res_id", "asym_id")}
    sampler = em.EMSampler(net, R3Diffuser(R3Config()), SO3Diffuser(SO3Config()),
                           SamplerConfig(num_steps=3))
    out = sampler.sample(batch, 2, torch.Generator().manual_seed(0))
    assert torch.isfinite(out["pos"]).all()
    assert calls == {"sampler": 1, "forward": 0}
    where[0] = "forward"
    net(batch, batch["pos"][None], 0.5)
    assert calls == {"sampler": 1, "forward": 1}


@pytest.fixture
def exact_gather(monkeypatch):
    import jax.numpy as jnp

    import dfmdock_tpu.ops.gather as gather

    monkeypatch.setattr(gather, "gather_rows", lambda src, idx: jnp.take(src, idx, axis=0))


@pytest.mark.parametrize("rows", ["per forward", "hoisted", "static"])
def test_pair_heads_match_jax_egnn_net(rows, exact_gather):
    """The predict forward of EGNNNet, its row lists made in the forward,
    hoisted into the batch (batch['pair_rows']) or in the static form the
    samplers make (`prepare`), against JAX's EGNNNet: outputs within FWD_REL, and the gradients of a
    fixed combination of them with respect to every weight within GRAD_REL
    of each array's largest (knn-only edges)."""
    import jax
    import jax.numpy as jnp

    from _torch_parity import configs, jax_batch, jax_flat, padded, port_batch
    from dfmdock_tpu.models.egnn_net import EGNNNet as JaxEGNNNet
    from dfmdock_tpu_torch.params import to_state_dict

    jc, pc = configs(sample_size=0)
    params = JaxEGNNNet(jc).init(jax.random.PRNGKey(4))
    net = EGNNNet(pc)
    net.load_state_dict(to_state_dict(jax_flat(params)))
    b = padded(40, 24, seed=13, pad_to=CROP)
    cot = np.random.RandomState(2).randn(CROP, 3).astype(np.float32)
    outputs = ("tr_score", "rot_score", "f", "energy", "confidence_logits", "ires_logits")

    def combine(out, xp):
        return (out["energy"].sum() + 0.5 * out["confidence_logits"].sum()
                + (out["f"].reshape(CROP, 3) * xp.asarray(cot)).sum() + out["tr_score"].sum()
                + out["rot_score"].sum())

    def jloss(p):
        out = JaxEGNNNet(jc).apply(p, jax_batch(b, 0.3), jax.random.PRNGKey(1), predict=True)
        return combine(out, jnp), out

    (_, out_j), g_j = jax.value_and_grad(jloss, has_aux=True)(params)
    pb = port_batch(b)
    if rows == "hoisted":
        pb["pair_rows"] = pair_rows(pb)
    elif rows == "static":
        pb = net.prepare(pb, static=True)
        pb.pop("h0")
    out_p = net(pb, pb["pos"][None], 0.3)
    combine(out_p, torch).backward()
    for k in outputs:
        w = np.asarray(out_j[k], np.float64).reshape(-1)
        g = out_p[k].detach().double().numpy().reshape(-1)
        assert np.abs(g - w).max() <= FWD_REL * np.abs(w).max() + 1e-7, k
    g_j = to_state_dict(jax_flat(g_j))
    for name, p in net.named_parameters():
        got = np.zeros(p.shape) if p.grad is None else p.grad.numpy()
        want = g_j[name].numpy()
        assert np.abs(got - want).max() <= GRAD_REL * np.abs(want).max() + 1e-7, name


def step_pair(lineage, dtype, device):
    """Two copies of one small net, each with its AdamW, for two runs of the
    same training."""
    net = small_net(lineage, dtype).to(device)
    twin = copy.deepcopy(net)
    _, loss_fn, exp_kw = LOSSES[lineage]
    exp = ExperimentConfig(**exp_kw)
    return (net, make_optimizer(net, exp)), (twin, make_optimizer(twin, exp)), loss_fn, exp


def assert_same_weights(a, b, tag):
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), (tag, k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lineage", ["mlsb", "dfmdock"])
def test_pool_step_eager_equals_train_step(lineage, dtype, diffusers):
    """PoolStep's steps, run eagerly, against train_step on the rows its
    permutation picks (rotated, from the same generator): the weights after
    each step, the metrics and the generator's state after, bit-equal; a
    pool of the same shapes loaded again is copied into the buffers."""
    (net, opt), (twin, opt_t), loss_fn, exp = step_pair(lineage, dtype, "cpu")
    pool = small_pool(2)
    gen, gen_t = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    stepper = PoolStep(net, *diffusers, exp, opt, loss_fn, gen)
    stepper.load(pool)
    buffers = {k: v.data_ptr() for k, v in stepper.pool.items()}
    want = []
    for epoch in range(2):
        steps = stepper.start()
        perm = torch.randperm(2, generator=gen_t)
        assert steps == 2 and torch.equal(stepper.perm, perm)
        for i in range(steps):
            stepper.step()
            want.append(train_step(twin, *diffusers, exp, opt_t, loss_fn,
                                   [{k: v[perm[i : i + 1]][0] for k, v in pool.items()}],
                                   gen_t, rotate=True))
            assert_same_weights(net, twin, (epoch, i))
        got = stepper.history()
        for k in got:
            assert torch.equal(got[k], torch.stack([m[k] for m in want[-steps:]])), k
        stepper.load({k: v.flip(0) for k, v in pool.items()})
        pool = {k: v.flip(0) for k, v in pool.items()}
    assert {k: v.data_ptr() for k, v in stepper.pool.items()} == buffers
    assert torch.equal(gen.get_state(), gen_t.get_state())
    assert stepper.captures == stepper.replays == 0


def recording(loss_fn, seen):
    """loss_fn that also copies each rotated row's coordinates into the
    static buffer `seen` (a replayed graph rewrites it)."""
    def fn(net, r3, so3, batch, generator, exp, injected=None):
        seen.copy_(batch["pos"])
        return loss_fn(net, r3, so3, batch, generator, exp, injected)
    return fn


@pytest.fixture
def deterministic():
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield
    torch.use_deterministic_algorithms(False)


@pytest.mark.cuda
@pytest.mark.parametrize("lineage", ["mlsb", "dfmdock"])
def test_captured_steps_equal_eager_steps(lineage, deterministic):
    """Two epochs of two steps, the pool refreshed between them (`load` of
    a second pool of the same shapes, copied into the captured buffers),
    through the captured graph (warm-up, capture, three replays) against
    as many eager steps on the card from one generator seed, both under
    torch.use_deterministic_algorithms (the gathers' backward otherwise
    adds in any order, and Adam's sign-like first step turns that into
    weights 2 lr apart): the weights after every step bit-equal and the
    last step's gradients bit-equal (else within rel 1e-3 of each array's
    largest, naming the arrays), the generator's state after equal, and
    the two replays of the second epoch rotating its one row differently."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA graphs run only there")
    dev = torch.device("cuda")
    diff = R3Diffuser(R3Config()), SO3Diffuser(SO3Config())
    (net, opt), (twin, opt_t), loss_fn, exp = step_pair(lineage, "float32", dev)
    first = {k: v.to(dev) for k, v in small_pool(2).items()}
    second = {k: v[1:].expand(2, *v.shape[1:]).contiguous().to(dev)
              for k, v in small_pool(2, seed=21).items()}
    seen = torch.zeros(CROP, 3, 3, device=dev)
    gens = [torch.Generator(dev).manual_seed(11) for _ in range(2)]
    steppers = [PoolStep(n, *diff, exp, o, recording(loss_fn, seen), g, capture=c)
                for n, o, g, c in ((net, opt, gens[0], True), (twin, opt_t, gens[1], False))]
    rotated = []
    for epoch, pool in enumerate((first, second)):
        for s in steppers:
            s.load(pool)
            assert s.start() == 2
        for i in range(2):
            for s in steppers:
                s.step()
                torch.cuda.synchronize()
                if s.capture:
                    rotated.append(seen.clone())
            assert_same_weights(net, twin, (epoch, i))
    assert steppers[0].captures == 1 and steppers[0].replays == 3
    assert not torch.equal(rotated[2], rotated[3])
    bad = {}
    for (name, p), q in zip(net.named_parameters(), twin.parameters()):
        if p.grad is not None and not torch.equal(p.grad, q.grad):
            bad[name] = float((p.grad - q.grad).abs().max() / q.grad.abs().max())
    assert all(r <= GRAD_REL for r in bad.values()), bad
    assert torch.equal(gens[0].get_state(), gens[1].get_state())
