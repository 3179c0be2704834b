"""bfloat16 compute (`ModelConfig.compute_dtype = "bfloat16"`): the port against
the JAX package at bf16 on the CPU.

The JAX package casts each Linear's input and weight to bf16 and multiplies
with a float32 result (`dfmdock_tpu.models.modules.linear`); the port's
`models.modules.linear` rounds both to bf16 and multiplies the rounded values
in float32.  The products of bf16 values are exact in float32, so the two
differ only in the order of the float32 accumulation: at a few small shapes
the two libraries sum in the same order and the results are bit-equal,
forward and input gradient; at layer widths the forwards agree to float32
rounding and the gradients, each rounded to bf16 by the transpose of the
cast on both sides, are equal but where a sum lies at a bf16 rounding tie.

The rest holds at tolerances stated with their reasons.  Inputs to a cast
that are equal up to float32 accumulation order round alike except at bf16
ties, where one element moves by one bf16 step (up to 2^-8 of it); in the
last layer of the mlsb net at seed 5, 2 of the 4096 inputs of node_mlp.l1
flip and move h by 1e-4 of its largest.  So outputs and loss terms are held
within 2^-8 (one bf16 step) of their largest, rather than 1e-3: the loss on
dedx (ec_loss) reads 1.7e-3 at the DFMDock case's seed.  Gradients, dedx
among them, are held within 1e-2 of each array's largest plus 1e-2 of the
largest of all: the backward rounds every cotangent to bf16 at each cast
and the second-order backward rounds again, which leaves an error set by
the largest gradients (measured up to 1.2e-2 of the largest of all).  That
is noise, not a difference of formula: the port with its cast products
summed in float64 differs from the port itself by about as much as from
JAX (in the DFMDock case 1.5-2.1% of the largest of the arrays that differ
most, against 1.9-6.0% from eager JAX).  The JAX side runs under jax.jit,
which keeps the file near a minute.  One layer, whose inputs are exact on both
sides, is held far tighter (LAYER_REL), and catches a product left in
float32.  The measured worst values are in each test's docstring.  The inputs are seeded
with numpy; one pose, two layers, narrow widths (tests/_torch_parity.py
SMALL); deterministic edges (kNN only: torch and JAX RNGs cannot match);
JAX's one-hot bf16 `gather_rows` replaced by an exact gather (its backward
rounds the cotangent to bf16: ROADMAP F5).

The route rule: every forward honours `compute_dtype`, the kernel route
(`use_pallas`, `ModelConfig.fast()`) too, where ops/fused_egcl runs its
single-pass bf16 mode; `fast(compute_dtype="float32")` is the float32
kernel route (tests/test_torch_fast_bf16.py holds fast() against JAX's).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import configs, jax_batch, jax_flat, padded, port_batch, port_net
from dfmdock_tpu.models import ScoreNet as JaxScoreNet
from dfmdock_tpu.models import modules as jax_modules
from dfmdock_tpu.models.egnn import egcl_apply, egcl_init
from dfmdock_tpu.models.egnn_net import EGNNNet as JaxEGNNNet
from dfmdock_tpu_torch.config import ModelConfig
from dfmdock_tpu_torch.models import EGNNNet, ScoreNet
from dfmdock_tpu_torch.models.egnn import EGCL
from dfmdock_tpu_torch.models.modules import compute_dtype, linear, pair_energy_rows
from dfmdock_tpu_torch.params import to_state_dict
from test_torch_losses import check, diffusers, run_both  # noqa: F401 (fixture)

BF16 = dict(compute_dtype="bfloat16")
OUT_REL = 2.0**-8  # outputs and loss terms: one bf16 step
GRAD_REL = 1e-2    # gradients and dedx, of each array's largest ...
GRAD_FLOOR = 1e-2  # ... plus this share of the largest gradient of all
LAYER_REL = 1e-5   # one layer from exact inputs: a product left in float32
                   # where JAX casts moves h by ~1e-3
CAST_WEIGHTS = {"edge_mlp.l0.weight", "edge_mlp.l1.weight", "att_mlp.l0.weight",
                "coord_mlp.l0.weight", "node_mlp.l0.weight", "node_mlp.l1.weight"}


@pytest.fixture(autouse=True)
def exact_gather(monkeypatch):
    import dfmdock_tpu.ops.gather as gather

    monkeypatch.setattr(gather, "gather_rows", lambda src, idx: jnp.take(src, idx, axis=0))


def within(got, want, rel, name, floor=1e-7, bf16_ulp=False):
    """|got - want| <= rel * max |want| + floor, and with `bf16_ulp` one
    bf16 ulp of the element (<= 2^-7 of it) beside, for gradients both
    sides round to bf16."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    assert np.isfinite(got).all(), name
    err = np.abs(got - want)
    bound = rel * np.abs(want).max() + floor + (2.0**-7 * np.abs(want) if bf16_ulp else 0.0)
    assert (err <= bound).all(), f"{name}: err {err.max():.3e}"


def both_linears(shape, bias, seed=0):
    """(JAX y, JAX dy/dx . g, port y, port dy/dx . g, (x, w, b)) at bf16 for
    x [..., k] and w [k, n]."""
    *lead, k, n = shape
    rng = np.random.RandomState(seed)
    x = rng.randn(*lead, k).astype(np.float32)
    w = (rng.randn(k, n) * 0.1).astype(np.float32)
    g = rng.randn(*lead, n).astype(np.float32)
    p = {"w": jnp.asarray(w)}
    b = rng.randn(n).astype(np.float32) if bias else None
    if bias:
        p["b"] = jnp.asarray(b)
    y_j, vjp = jax.vjp(lambda xx: jax_modules.linear(p, xx, jnp.bfloat16), jnp.asarray(x))
    (g_j,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    y_p = linear(xt, torch.from_numpy(w).t(), None if b is None else torch.from_numpy(b),
                 torch.bfloat16)
    y_p.backward(torch.from_numpy(g))
    return np.asarray(y_j), np.asarray(g_j), y_p.detach().numpy(), xt.grad.numpy(), (x, w, b)


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("shape", [(5, 7, 3), (2, 5, 7, 3), (6, 9, 5)])
def test_linear_bit_equal_to_jax(shape, bias):
    """Where both libraries sum in one order, the helper is JAX's
    `modules.linear` at bf16 bit for bit, forward and input gradient."""
    y_j, g_j, y_p, g_p, _ = both_linears(shape, bias)
    np.testing.assert_array_equal(y_p, y_j)
    np.testing.assert_array_equal(g_p, g_j)


@pytest.mark.parametrize("shape", [(448, 256, 256), (64, 1301, 32)])
def test_linear_at_layer_width(shape):
    """At layer widths the forwards differ by float32 accumulation order
    alone (each within 1e-6 of the largest of the float64 product of the
    rounded values) and the input gradients are bf16 values equal to JAX's
    but at ties, one bf16 ulp apart (measured: none / 1.6e-4 of the
    elements at the two shapes)."""
    y_j, g_j, y_p, g_p, (x, w, b) = both_linears(shape, True, seed=1)
    bf = lambda a: torch.from_numpy(a).bfloat16().double().numpy()
    exact = bf(x) @ bf(w) + b
    for y in (y_j, y_p):
        within(y, exact, 1e-6, "forward")
    assert np.array_equal(bf(g_p), g_p)  # every gradient element a bf16 value
    unequal = g_p != g_j
    ulp = np.abs(g_j) * 2.0 ** -7  # one bf16 ulp of the element, at most
    assert unequal.mean() < 0.02
    assert (np.abs(g_p - g_j)[unequal] <= ulp[unequal] + 1e-30).all()


def test_compute_dtype_route_rule():
    """bf16 wherever the config says so, the kernel route too; float32
    configs never cast; fast() is bf16, as the JAX package's."""
    assert compute_dtype(ModelConfig()) is None
    assert compute_dtype(ModelConfig(**BF16)) is torch.bfloat16
    assert compute_dtype(ModelConfig.fast()) is torch.bfloat16
    assert compute_dtype(ModelConfig.fast(compute_dtype="float32")) is None
    assert dataclasses.asdict(ModelConfig.fast())["compute_dtype"] == "bfloat16"


@pytest.mark.parametrize("update_coords", [False, True])
def test_egcl_layer_matches_jax(update_coords):
    """One eager E_GCL layer at bf16 against JAX's egcl_apply(dtype=bf16):
    h and the coordinate update within rel 1e-3, and the gradients of a
    seeded projection of both with respect to h, the coordinates and every
    weight within 1e-5 of each array's largest plus 1e-5 of the largest of
    all (the first node-MLP bias sits ahead of GraphNorm, which subtracts
    the mean, so its gradient is zero but for rounding noise), and the cast
    weights' gradients, which both sides round to bf16, within one bf16 ulp
    of each element beside (2 of node_mlp.l0's 2048 are).  The inputs are
    exact on both sides, so few casts can meet a tie here.  Measured:
    forward <= 6.7e-8, other gradients <= 2.9e-6 of their largest."""
    n, k, c, e = 48, 12, 32, 16
    rng = np.random.RandomState(7 + update_coords)
    h = rng.randn(n, c).astype(np.float32)
    ca = (rng.randn(n, 3) * 6).astype(np.float32)
    idx = np.stack([rng.choice(n, k, replace=False) for _ in range(n)]).astype(np.int32)
    edge_mask = (rng.rand(n, k) > 0.1).astype(np.float32)
    edge_attr = rng.randn(n, k, e).astype(np.float32)
    node_mask = np.arange(n) < 44
    lig = ((np.arange(n) >= 30) & node_mask).astype(np.float32)
    g_h = rng.randn(n, c).astype(np.float32)
    g_x = rng.randn(n, 3).astype(np.float32)
    p = egcl_init(jax.random.PRNGKey(3), c, e, update_coords)

    def jax_loss(p, h, ca):
        h2, x2 = egcl_apply(p, h, ca, jnp.asarray(idx), jnp.asarray(edge_mask),
                            jnp.asarray(edge_attr), jnp.asarray(node_mask), jnp.asarray(lig),
                            normalize=True, update_coords=update_coords, dtype=jnp.bfloat16)
        return (h2 * g_h).sum() + (x2 * g_x).sum(), (h2, x2)

    (_, (h_j, x_j)), grads_j = jax.jit(jax.value_and_grad(jax_loss, argnums=(0, 1, 2),
                                                          has_aux=True))(
        p, jnp.asarray(h), jnp.asarray(ca))
    layer = EGCL(c, e, update_coords)
    layer.load_state_dict(to_state_dict(jax_flat(p)))
    T = lambda a: torch.from_numpy(np.asarray(a))
    h_t, ca_t = T(h)[None].requires_grad_(True), T(ca)[None].requires_grad_(True)
    h_p, x_p = layer(h_t, ca_t, T(idx)[None], T(edge_mask)[None], T(edge_attr)[None],
                     T(node_mask), T(lig), normalize=True, dtype=torch.bfloat16)
    ((h_p * T(g_h)).sum() + (x_p * T(g_x)).sum()).backward()
    want = to_state_dict(jax_flat(grads_j[0]))
    floor = LAYER_REL * max(float(np.abs(g).max()) for g in [*want.values(), *grads_j[1:]])
    within(h_p[0].detach(), h_j, LAYER_REL, "h")
    within(x_p[0].detach() - T(ca), np.asarray(x_j) - ca, LAYER_REL, "coord update")
    within(h_t.grad[0], grads_j[1], LAYER_REL, "d/dh", floor)
    within(ca_t.grad[0], grads_j[2], LAYER_REL, "d/dcoord", floor)
    for name, param in layer.named_parameters():
        within(param.grad, want[name], LAYER_REL, name, floor, bf16_ulp=name in CAST_WEIGHTS)


def test_pair_energy_rows_matches_jax():
    """One row chunk of the mlsb energy head at bf16 (the JAX package's
    `_energy_and_grad_h` body: LayerNorm, silu, the cast last product) and
    its hand-written gradients against jax.value_and_grad, within 1e-5:
    the gradients use the rounded w2, as JAX's do.  Measured: 0 (num),
    <= 1.6e-7 (gradients)."""
    rng = np.random.RandomState(4)
    c, rows, n = 32, 16, 24
    hr = rng.randn(rows, c).astype(np.float32)
    hl = rng.randn(n, c).astype(np.float32)
    mask = (rng.rand(rows, n) > 0.3).astype(np.float32)
    ln_g, ln_b = 1 + 0.1 * rng.randn(2, c).astype(np.float32)
    w2 = (0.1 * rng.randn(c)).astype(np.float32)

    def chunk_num(hr_c, hl_in):
        e = jax_modules.layer_norm({"g": ln_g, "b": ln_b}, hr_c[:, None, :] + hl_in[None])
        e = jax_modules.linear({"w": w2[:, None]}, jax.nn.silu(e), jnp.bfloat16)[..., 0]
        return (e * mask).sum()

    num_j, (g_hr_j, g_hl_j) = jax.value_and_grad(chunk_num, argnums=(0, 1))(
        jnp.asarray(hr), jnp.asarray(hl))
    T = lambda a: torch.from_numpy(a)
    num_p, g_hr_p, g_hl_p, _ = pair_energy_rows(
        T(hr)[None], T(hl)[None], T(mask)[None], T(ln_g), T(ln_b), T(w2), with_grads=True,
        dtype=torch.bfloat16)
    within(num_p[0], num_j, LAYER_REL, "num")
    within(g_hr_p[0], g_hr_j, LAYER_REL, "d num / d hr")
    within(g_hl_p[0], g_hl_j, LAYER_REL, "d num / d hl")


def nets(lineage, seed, **cfg):
    """(JAX net, its params, the port's net carrying them) at SMALL widths,
    kNN-only edges and `cfg`."""
    jcfg, pcfg = configs(sample_size=0, **cfg)
    jnet = (JaxScoreNet if lineage == "mlsb" else JaxEGNNNet)(jcfg)
    params = jnet.init(jax.random.PRNGKey(seed))
    if lineage == "mlsb":
        return jnet, params, port_net(pcfg, params)
    pnet = EGNNNet(pcfg)
    pnet.load_state_dict(to_state_dict(jax_flat(params)))
    return jnet, params, pnet.eval()


TRAIN_KEYS = {"mlsb": ("tr_score", "rot_score", "f", "energy", "ires", "dedx"),
              "dfmdock": ("tr_score", "rot_score", "f", "energy", "ires_logits",
                          "confidence_logits", "dist_loss", "dedx")}


@pytest.mark.parametrize("lineage", ["mlsb", "dfmdock"])
def test_training_forward_matches_jax(lineage):
    """apply_train(dedx=True) at bf16 against JAX's apply(train=True) at
    ModelConfig(compute_dtype="bfloat16"): every output within 2^-8 of its
    largest (measured <= 3.4e-4, ires_logits), dedx within 1e-2 (measured
    1.9e-3 mlsb, 1.6e-4 DFMDock)."""
    jnet, params, pnet = nets(lineage, 2, **BF16)
    batch = padded(40, 30, seed=5)
    kw, pkw = {}, {}
    if lineage == "dfmdock":
        ca = batch["pos"][:, 1]
        gt = np.sqrt(np.maximum(((ca[:, None] - ca[None]) ** 2).sum(-1), 1e-12))
        kw, pkw = {"gt_dist": jnp.asarray(gt)}, {"gt_dist": torch.from_numpy(gt)[None].float()}
    want = jax.jit(lambda p, b: jnet.apply(p, b, jax.random.PRNGKey(0), train=True, **kw))(
        params, jax_batch(batch, 0.3))
    got = pnet.apply_train(port_batch(batch), torch.from_numpy(batch["pos"])[None],
                           torch.tensor(0.3), dedx=True, **pkw)
    for k in TRAIN_KEYS[lineage]:
        w = np.asarray(want[k])
        within(got[k].detach().numpy().reshape(w.shape), w,
               GRAD_REL if k == "dedx" else OUT_REL, k)
    # the energy of return_energy is the dedx forward's
    e_only = pnet.apply_train(port_batch(batch), torch.from_numpy(batch["pos"])[None],
                              torch.tensor(0.3), return_energy=True)
    within(e_only.detach(), got["energy"].detach(), 1e-6, "return_energy")


@pytest.mark.parametrize("lineage", ["mlsb", "dfmdock"])
def test_loss_and_gradients_match_jax(lineage, diffusers):  # noqa: F811
    """One loss-and-gradient step at bf16 with the second-order energy term
    (--grad-energy; the contrastive term on mlsb, the distogram and
    confidence terms on DFMDock): every loss term within 2^-8, every
    weight's gradient within 1e-2 of its largest plus 1e-2 of the largest
    of all.  Measured: loss terms <= 1.7e-3 (DFMDock's ec_loss), 7.9e-4
    (mlsb); gradients <= 1.2e-2 (mlsb) and 4.7e-3 (DFMDock) of the largest
    of all."""
    exp = (dict(grad_energy=True, use_contrastive_loss=True) if lineage == "mlsb" else
           dict(grad_energy=True, use_confidence_loss=True, use_dist_loss=True))
    jterms, pterms, jgrads, pparams = run_both(lineage, exp, diffusers, jit=True, **BF16)
    top = max(float(np.abs(g.numpy()).max()) for g in jgrads.values())
    check(jterms, pterms, jgrads, pparams, loss_rel=OUT_REL, grad_rel=GRAD_REL,
          grad_floor=GRAD_FLOOR * top)


@pytest.mark.parametrize("lineage", ["mlsb", "dfmdock"])
def test_eager_predict_matches_jax(lineage):
    """The predict forward on the eager route at bf16 against JAX's
    apply(predict=True) at bf16 without Pallas: every output within 2^-8
    of its largest (measured <= 2.9e-4, the mlsb force), num_clashes
    exact."""
    jnet, params, pnet = nets(lineage, 4, **BF16)
    batch = padded(40, 30, seed=8)
    want = jax.jit(lambda p, b: jnet.apply(p, b, jax.random.PRNGKey(0), predict=True))(
        params, jax_batch(batch, 0.4))
    pb = port_batch(batch)
    with torch.no_grad():
        got = pnet(pb, pb["pos"][None], 0.4)
    keys = (("tr_score", "rot_score", "f", "energy", "ires") if lineage == "mlsb" else
            ("tr_score", "rot_score", "f", "energy", "ires_logits", "confidence_logits"))
    for k in keys:
        w = np.asarray(want[k])
        within(got[k].numpy().reshape(w.shape), w, OUT_REL, k)
    assert int(got["num_clashes"][0]) == int(want["num_clashes"])


def composed_stack(net, batch, pos, edges, dtype):
    """The kernel route's embedding and EGCL stack written out from the
    plain kernels: in float32 (dtype None) with the float32 route's own
    products (a = h W_hi + b, B = h W_hj, the tables' float32 products,
    the three-pass mode's plain version), with bf16 as the JAX package's
    `egnn_apply_fused(dtype=)` (`modules.linear` products, the kernel's
    single-pass mode).  Returns (h0, h, CA coordinates)."""
    from dfmdock_tpu_torch.ops.edge_table import build_edge_table_plain
    from dfmdock_tpu_torch.ops.fused_egcl import fused_edge_layer_plain

    c = net.cfg
    idx, edge_mask = edges
    lig = batch["lig_mask"] * batch["node_mask"].float()
    h0 = linear(batch["x"], net.single_embed.weight, dtype=dtype)
    h, coord = h0.expand(pos.shape[0], -1, -1), pos[..., 1, :]
    ebin, egeo = build_edge_table_plain(idx, pos, batch["res_id"], batch["asym_id"],
                                        normalize=c.normalize)
    for layer in net.egnn:
        w_hi, w_hj, w_r, w_e = layer.edge_weights()
        b0, l1, att = layer.edge_mlp["l0"].bias, layer.edge_mlp["l1"], layer.att_mlp["l0"]
        if dtype is None:
            a, B = h @ w_hi + b0, h @ w_hj
        else:
            a, B = linear(h, w_hi.t(), b0, dtype), linear(h, w_hj.t(), dtype=dtype)
        coord_params = None if layer.coord_mlp is None else (
            layer.coord_mlp["l0"].weight.t(), layer.coord_mlp["l0"].bias,
            layer.coord_mlp["l1"].weight[0])
        out = fused_edge_layer_plain(
            idx, edge_mask, ebin, egeo, a, B, net.spatial_embed.weight.t() @ w_e,
            net.positional_embed.weight.t() @ w_e, w_r, l1.weight.t(), l1.bias, att.weight[0],
            att.bias, coord_params, dtype)
        agg = out if coord_params is None else out[0]
        if coord_params is not None:
            count = edge_mask.sum(-1, keepdim=True).clamp(min=1.0)
            coord = coord + (out[1] / count) * lig[:, None]
        h = layer.node_update(h, agg, batch["node_mask"], dtype)
    return h0, h, coord


@pytest.mark.parametrize("lineage", ["mlsb", "dfmdock"])
def test_kernel_route_follows_compute_dtype(lineage):
    """fast() (bf16) and fast(compute_dtype="float32") on the same weights
    and edges, on CPU tensors (the kernels' plain versions): each route's
    embedding and EGCL stack equal to their composition from the plain
    kernels (`composed_stack`; float32 the float32 route's own products),
    the mlsb energy head's halves cast alike, and the two routes' outputs
    apart."""
    from _torch_parity import SMALL
    from dfmdock_tpu_torch.models.edges import select_edges
    from dfmdock_tpu_torch.models.egnn import edge_stack
    from dfmdock_tpu_torch.ops.energy_head import fused_energy_plain

    net_cls = ScoreNet if lineage == "mlsb" else EGNNNet
    batch = port_batch(padded(40, 30, seed=9))
    pos = batch["pos"][None]
    edges = select_edges(torch.cdist(pos[..., 1, :], pos[..., 1, :]), batch["node_mask"], 20,
                         0)
    outs = {}
    for dtype, name in ((torch.bfloat16, "bfloat16"), (None, "float32")):
        net = net_cls(ModelConfig.fast(compute_dtype=name, **SMALL))
        net.init_weights(torch.Generator().manual_seed(3))
        lig = batch["lig_mask"] * batch["node_mask"].float()
        with torch.no_grad():
            h0 = net.embed_nodes(batch["x"])
            h, coord = edge_stack(net.cfg, net.egnn, net.spatial_embed.weight.t(),
                                  net.positional_embed.weight.t(), batch, pos, h0.expand(1, -1, -1),
                                  *edges, lig, dtype=compute_dtype(net.cfg))
            want = composed_stack(net, batch, pos, edges, dtype)
            for got, ref, what in zip((h0, h, coord), want, ("h0", "h", "coord")):
                assert torch.equal(got, ref), f"{name} {what}"
            if lineage == "mlsb":
                c = h.shape[-1]
                w, ln = net.to_energy["l0"].weight, net.to_energy["ln"]
                mask = (1.0 - lig)[:, None] * lig[None, :] * torch.ones(1, 1, 1)
                e = net._energy(h, mask)
                halves = ((h @ w[:, :c].t(), h @ w[:, c:].t()) if dtype is None else
                          (linear(h, w[:, :c], dtype=dtype), linear(h, w[:, c:], dtype=dtype)))
                assert torch.equal(e, fused_energy_plain(*halves, mask, ln.weight, ln.bias,
                                                         net.to_energy["l1"].weight[0]))
            outs[name] = net({**batch, "h0": h0}, pos, 0.3, edges=edges)
    for k, v in outs["float32"].items():
        assert torch.isfinite(v.float()).all() and torch.isfinite(outs["bfloat16"][k].float()).all()
    for k in ("tr_score", "rot_score", "f", "energy"):
        assert not torch.equal(outs["bfloat16"][k], outs["float32"][k]), k
