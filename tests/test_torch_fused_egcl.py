"""The port's plain fused EGCL (ops/fused_egcl.fused_edge_layer_plain, what
the CUDA kernel is held against on the card) vs the JAX package:

- against the Pallas fused_edge_layer in interpret mode, which runs its
  products in bf16: the float32 mode at bf16 tolerances as
  tests/test_pallas_ops.py states them (rtol 5e-2, atol 2e-3, here relative
  to the output's magnitude), the single-pass bf16 mode, which rounds as
  the Pallas kernel does, within 1e-3 of the output's largest;
- through the port's fused EGCL layer against the JAX eager f32 egcl_apply
  on the same parameters and bins: rtol 1e-4 (f32 on both sides)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
from dfmdock_tpu.features.sixd import pairwise_ca_dist, sixd_bins_at, spatial_embed_from_bins
from dfmdock_tpu.features.positional import relpos_bin_at
from dfmdock_tpu.models.edges import select_edges
from dfmdock_tpu.models.egnn import build_edge_table_xla, egcl_apply, egcl_init
from dfmdock_tpu.ops import fused_egcl as jf
from dfmdock_tpu_torch.models.egnn import EGCL, egnn_apply_fused
from dfmdock_tpu_torch.ops import edge_table as et
from dfmdock_tpu_torch.ops.fused_egcl import (
    BUILD_ORDER,
    SLICE_K,
    SLICE_K_BF16,
    TABLE_ROWS,
    fused_edge_layer,
    fused_edge_layer_plain,
    prepare_layer,
    prepare_weight,
    prepare_weight_bf16,
    split_bf16,
)
from dfmdock_tpu_torch.models.egnn import fused_weights
from dfmdock_tpu_torch.params import to_state_dict

C, E_DIM = 32, 16


def port_table(tab, n, k):
    """The JAX [16, N*K] edge table as the port's (idx, edge_mask, ebin,
    egeo), so both sides see identical edges and bins."""
    ebin = np.zeros((n * k, et.EBIN_WIDTH), np.int32)
    for r, col in ((jf.R_DB, et.E_DB), (jf.R_OB, et.E_OB), (jf.R_TB, et.E_TB),
                   (jf.R_PB, et.E_PB), (jf.R_RP, et.E_RP)):
        ebin[:, col] = np.rint(tab[r]).astype(np.int32)
    egeo = np.stack([tab[jf.R_RAD]] + [tab[jf.R_CD + d] for d in range(3)], -1)
    idx = np.rint(tab[jf.R_IDX]).astype(np.int32).reshape(1, n, k)
    mask = np.array(tab[jf.R_MASK], np.float32).reshape(1, n, k)
    return (torch.from_numpy(idx), torch.from_numpy(mask),
            torch.from_numpy(ebin.reshape(1, n, k, -1)),
            torch.from_numpy(np.ascontiguousarray(egeo, np.float32).reshape(1, n, k, 4)))


def graph(n_rec, n_lig, pad_to, seed):
    b = tp.padded(n_rec, n_lig, feat=8, seed=seed, pad_to=pad_to)
    pos = jnp.asarray(b["pos"])
    idx, mask = select_edges(jax.random.PRNGKey(seed), pairwise_ca_dist(pos),
                             jnp.asarray(b["node_mask"]), knn=20, sample_size=40)
    tab = build_edge_table_xla(idx, mask, pos, jnp.asarray(b["res_id"]),
                               jnp.asarray(b["asym_id"]), normalize=True)
    return b, pos, idx, mask, np.asarray(tab)


def layer_case(coord, n_rec, n_lig, pad_to, seed):
    """Inputs as the model makes them: a layer of egcl_init weights
    (N(0, 0.02)) applied to unit-normal node features, the embed tables'
    product with W_e in float32.  Returns (JAX's Pallas fused_edge_layer
    outputs, the port's wrapper's arguments but for `dtype`)."""
    b, pos, idx, mask, tab = graph(n_rec, n_lig, pad_to, seed)
    n, k = idx.shape
    key = jax.random.PRNGKey(seed)
    p = egcl_init(key, C, E_DIM, coord)
    h = jax.random.normal(jax.random.fold_in(key, 1), (n, C))
    w0 = p["edge_mlp"]["l0"]["w"]
    a = h @ w0[:C] + p["edge_mlp"]["l0"]["b"]
    B = h @ w0[C : 2 * C]
    w_e = w0[2 * C + 1 :]
    sp_w = jax.random.normal(jax.random.fold_in(key, 2), (100, E_DIM)) * 0.02
    rp_w = jax.random.normal(jax.random.fold_in(key, 3), (66, E_DIM)) * 0.02
    t_sp, t_p = sp_w @ w_e, rp_w @ w_e
    l1, att = p["edge_mlp"]["l1"], p["att_mlp"]["l0"]
    wc = ((p["coord_mlp"]["l0"]["w"], p["coord_mlp"]["l0"]["b"],
           p["coord_mlp"]["l1"]["w"][:, 0]) if coord else None)
    out_j = jf.fused_edge_layer(
        jnp.asarray(tab), a, B, t_sp.astype(jnp.bfloat16), t_p.astype(jnp.bfloat16),
        w0[2 * C][None], l1["w"], l1["b"][None], att["w"][:, 0][None], att["b"][None], k=k,
        coord_params=(wc[0], wc[1][None], wc[2][None]) if coord else None)
    T = lambda x: torch.from_numpy(np.array(x, np.float32))
    args = (*port_table(tab, n, k), T(a)[None], T(B)[None], T(t_sp), T(t_p), T(w0[2 * C]),
            T(l1["w"]), T(l1["b"]), T(att["w"][:, 0]), T(att["b"]),
            tuple(map(T, wc)) if coord else None)
    return (out_j if coord else (out_j,)), args


LAYER_CASES = [(20, 12, 64, 3), (50, 40, 128, 5)]


@pytest.mark.parametrize("coord", [False, True])
@pytest.mark.parametrize("n_rec,n_lig,pad_to,seed", LAYER_CASES)
def test_plain_matches_jax_pallas_kernel(coord, n_rec, n_lig, pad_to, seed):
    """The float32 mode against the Pallas kernel, which runs its products
    in bf16 (the tables rounded to bf16 on the port's side too, as the
    JAX package passes them).  The raw squared edge length enters the edge
    MLP, so agg runs to ~1e2 here: the bf16 atol is taken relative to the
    output's magnitude (2e-3 * max |ref|)."""
    out_j, args = layer_case(coord, n_rec, n_lig, pad_to, seed)
    bf = lambda x: x.to(torch.bfloat16).float()
    args = (*args[:6], bf(args[6]), bf(args[7]), *args[8:])
    out_p = fused_edge_layer(*args)
    for j, o in zip(out_j, out_p if coord else (out_p,)):
        scale = np.abs(np.asarray(j)).max()
        assert scale > 1e-4
        np.testing.assert_allclose(o[0].numpy(), np.asarray(j), rtol=5e-2,
                                   atol=2e-3 * scale)


BF16_LAYER_REL = 1e-3


@pytest.mark.parametrize("coord", [False, True])
@pytest.mark.parametrize("n_rec,n_lig,pad_to,seed", LAYER_CASES)
def test_plain_bf16_matches_jax_pallas_kernel(coord, n_rec, n_lig, pad_to, seed):
    """The single-pass bf16 mode (`dtype=torch.bfloat16`) against the
    Pallas kernel in interpret mode: both round a, B, the tables, silu(pre)
    and m2g to bf16 (round to nearest) and both products' weights, so they
    differ only where the float32 sums ahead of a rounding (pre, in another
    order; the TPU kernel's radial term is a truncated hi/lo split, ~2^-15
    relative) tip a value across a bf16 rounding boundary.  Every output
    within BF16_LAYER_REL of its largest (measured worst 3.0e-4 of the
    largest, the coord update at the small shape; agg <= 1.4e-4), while
    the float32 mode lies 1.7e-3 to 5.0e-3 of the largest away from JAX
    here, so the tolerance tells the modes apart."""
    out_j, args = layer_case(coord, n_rec, n_lig, pad_to, seed)
    out_b = fused_edge_layer(*args, dtype=torch.bfloat16)
    out_f = fused_edge_layer(*args)
    worst_f32 = 0.0
    for j, o, f in zip(out_j, *((x if coord else (x,)) for x in (out_b, out_f))):
        j = np.asarray(j, np.float64)
        scale = np.abs(j).max()
        assert scale > 1e-4
        err = np.abs(o[0].numpy() - j).max()
        assert err <= BF16_LAYER_REL * scale, f"{err / scale:.3e}"
        worst_f32 = max(worst_f32, np.abs(f[0].numpy() - j).max() / scale)
    assert worst_f32 > BF16_LAYER_REL


def test_wrapper_modes():
    """float32 (None) and bfloat16 are the two modes; another dtype raises,
    and on the CPU no kernel launch is counted."""
    b, pos, idx, mask, tab = graph(20, 12, 64, 3)
    g = torch.Generator().manual_seed(1)
    n, k = idx.shape
    r = lambda *s: torch.randn(s, generator=g) * 0.2
    args = (*port_table(tab, n, k), r(1, n, C), r(1, n, C), r(100, C), r(66, C), r(C),
            r(C, C), r(C), r(C), r(1))
    before = (fused_edge_layer.launches, fused_edge_layer.bf16_launches)
    assert not torch.equal(fused_edge_layer(*args), fused_edge_layer(*args, dtype=torch.bfloat16))
    assert (fused_edge_layer.launches, fused_edge_layer.bf16_launches) == before
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fused_edge_layer(*args, dtype=torch.float16)


@pytest.mark.parametrize("update_coords", [False, True])
def test_fused_layer_matches_jax_eager_f32(update_coords):
    b, pos, idx, mask, tab = graph(40, 30, 128, 11)
    n, k = idx.shape
    p = egcl_init(jax.random.PRNGKey(1), C, E_DIM, update_coords)
    sp_w = jax.random.normal(jax.random.PRNGKey(2), (100, E_DIM)) * 0.3
    rp_w = jax.random.normal(jax.random.PRNGKey(3), (66, E_DIM)) * 0.3
    h = jax.random.normal(jax.random.PRNGKey(4), (n, C))
    ca = pos[:, 1, :]
    lig = jnp.asarray(b["lig_mask"])
    node_mask = jnp.asarray(b["node_mask"])
    bins = sixd_bins_at(pos, idx)
    edge_attr = (spatial_embed_from_bins(sp_w, *bins)
                 + rp_w[relpos_bin_at(jnp.asarray(b["res_id"]), jnp.asarray(b["asym_id"]), idx)])
    h_j, x_j = egcl_apply(p, h, ca, idx, mask, edge_attr, node_mask, lig,
                          normalize=True, update_coords=update_coords)

    layer = EGCL(C, E_DIM, update_coords)
    layer.load_state_dict(to_state_dict(tp.jax_flat(p)))
    T = lambda x: torch.from_numpy(np.array(x))
    with torch.no_grad():
        h_p, x_p = egnn_apply_fused([layer], T(sp_w), T(rp_w), T(h)[None], T(ca)[None],
                                    *port_table(tab, n, k), T(node_mask), T(lig))
    tp.assert_close(h_p[0].numpy(), h_j, 1e-4, "h")
    tp.assert_close(x_p[0].numpy() - np.asarray(ca), np.asarray(x_j - ca), 1e-4, "coord update")
    if update_coords:
        assert np.abs(np.asarray(x_j - ca)).max() > 0


def test_masked_edges_drop_by_selection():
    """A NaN in a masked edge's geometry must not reach the sums."""
    b, pos, idx, mask, tab = graph(20, 12, 64, 3)
    n, k = idx.shape
    idx_t, mask_t, ebin, egeo = port_table(tab, n, k)
    masked = mask_t == 0
    assert masked.any()
    poisoned = egeo.clone()
    poisoned[masked] = float("nan")
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(s, generator=g) * 0.2
    args = (r(1, n, C), r(1, n, C), r(100, C), r(66, C), r(C), r(C, C), r(C), r(C), r(1))
    coord = (r(C, C), r(C), r(C))
    ref = fused_edge_layer_plain(idx_t, mask_t, ebin, egeo, *args, coord)
    out = fused_edge_layer_plain(idx_t, mask_t, ebin, poisoned, *args, coord)
    for o, rf in zip(out, ref):
        assert torch.isfinite(o).all()
        torch.testing.assert_close(o, rf, rtol=0, atol=0)


@pytest.mark.parametrize("c", [64, 256])
def test_prepare_weight_layout_and_split(c):
    """The weight as the three-pass CUDA kernel streams it: element (out n,
    in k) of W^T at the offset the kernel's wgmma descriptors read (slice
    k // SLICE_K, 8 x 8 core matrices, hi then lo piece), hi the
    round-to-nearest bf16 of W and hi + lo within 2^-16 of W.  A three-pass product on the pieces
    (hi.hi + lo.hi + hi.lo, exact products summed in float64) lies within
    1e-4 of the f32 product, relative to its largest value."""
    g = torch.Generator().manual_seed(c)
    w = torch.randn((c, c), generator=g) / np.sqrt(c)
    prepared = prepare_weight(w).float()
    assert prepared.shape == (c // SLICE_K, 2, SLICE_K * c)
    n = torch.arange(c)[:, None]
    k = torch.arange(c)[None, :]
    off = ((n // 8) * (SLICE_K // 8) + (k % SLICE_K) // 8) * 64 + (n % 8) * 8 + k % 8
    hi, lo = prepared[k // SLICE_K, 0, off], prepared[k // SLICE_K, 1, off]
    torch.testing.assert_close(hi, w.t().to(torch.bfloat16).float(), rtol=0, atol=0)
    assert ((hi + lo) - w.t()).abs().max() <= 2.0 ** -16 * w.abs().max()
    x = torch.nn.functional.silu(torch.randn((64, c), generator=g) * 2.0)
    (xh, xl), (wh, wl) = split_bf16(x), split_bf16(w)
    d = lambda t: t.double()
    three = d(xh) @ d(wh) + d(xl) @ d(wh) + d(xh) @ d(wl)
    ref = x @ w
    assert (three - d(ref)).abs().max() <= 1e-4 * ref.abs().max()


def decode_bf16_weight(prepared, c):
    """The inverse of prepare_weight_bf16's core-matrix layout: [C, C] of
    W^T's bf16 values, row n, column p = slice * SLICE_K_BF16 + fragment
    position (the offset the bf16 kernel's wgmma descriptors read)."""
    n = torch.arange(c)[:, None]
    pos = torch.arange(c)[None, :]
    ks = SLICE_K_BF16
    off = ((n // 8) * (ks // 8) + (pos % ks) // 8) * 64 + (n % 8) * 8 + pos % 8
    return prepared.float()[pos // ks, off]


def test_build_order_is_the_fragment_layout():
    """BUILD_ORDER against wgmma's register A fragment (PTX, m64nNk16 bf16:
    thread q of a quad holds columns 2q, 2q + 1 in registers 0 / 1 and
    2q + 8, 2q + 9 in registers 2 / 3 of each k-step): the bf16 kernel's
    thread q packs its loaded columns 8q + u as (u = 4 kk, 4 kk + 1) into
    register 0 / 1 and (u = 4 kk + 2, 4 kk + 3) into register 2 / 3 of
    k-step kk, so fragment position 16 kk + 2q + j holds column 8q + 4 kk + j
    and position 16 kk + 8 + 2q + j column 8q + 4 kk + 2 + j."""
    assert sorted(BUILD_ORDER) == list(range(SLICE_K_BF16))
    for q in range(4):
        for kk in range(2):
            for j in range(2):
                assert BUILD_ORDER[16 * kk + 2 * q + j] == 8 * q + 4 * kk + j
                assert BUILD_ORDER[16 * kk + 8 + 2 * q + j] == 8 * q + 4 * kk + 2 + j


@pytest.mark.parametrize("c", [64, 256])
def test_prepare_weight_bf16_layout(c):
    """The weights as the bf16 kernel streams them (slices of SLICE_K_BF16
    input rows, one bf16 piece): W_c0 in its own row order, W_l1 with each
    slice's rows in BUILD_ORDER, so that the product over fragment
    positions of A's columns taken in BUILD_ORDER is A @ W exactly (bf16
    values, float64 sums)."""
    g = torch.Generator().manual_seed(c)
    w = torch.randn((c, c), generator=g) / np.sqrt(c)
    wt16 = w.t().to(torch.bfloat16).float()
    natural = prepare_weight_bf16(w, False)
    assert natural.shape == (c // SLICE_K_BF16, SLICE_K_BF16 * c)
    assert natural.dtype == torch.bfloat16
    torch.testing.assert_close(decode_bf16_weight(natural, c), wt16, rtol=0, atol=0)
    ordered = prepare_weight_bf16(w, True)
    cols = (torch.arange(0, c, SLICE_K_BF16)[:, None] + torch.tensor(BUILD_ORDER)).reshape(-1)
    torch.testing.assert_close(decode_bf16_weight(ordered, c), wt16[:, cols], rtol=0, atol=0)
    x = torch.nn.functional.silu(torch.randn((64, c), generator=g)).to(torch.bfloat16).double()
    ref = x @ wt16.double().t()
    out = x[:, cols] @ decode_bf16_weight(ordered, c).double().t()
    assert (out - ref).abs().max() <= 1e-12 * ref.abs().max()


def emulate_bf16_kernel(idx, edge_mask, ebin, egeo, a, B16, w_r, b_l1, w_att, b_att,
                        prepared, coord_params):
    """The bf16 kernel's data path on the CPU from what its wrapper hands
    it: B as bf16, the [TABLE_ROWS, C] bf16 tables at the kernel's row
    offsets (T_sp's families at 0 / 40 / 64 / 88 plus their bin, T_p at
    100 plus the relpos class), the products through the prepared weights
    (W_l1's A columns in BUILD_ORDER), masked rows dropped by selection."""
    c = a.shape[-1]
    tab = prepared.tables.float()
    bins = ebin.long()
    pre = a.to(torch.bfloat16).float()[..., :, None, :] + B16.float()[0][idx.long()[0]][None]
    for col, base in ((et.E_DB, 0), (et.E_OB, 40), (et.E_TB, 64), (et.E_PB, 88),
                      (et.E_RP, 100)):
        pre = pre + tab[base + bins[..., col]]
    pre = pre + egeo[..., et.G_RAD, None] * w_r
    valid = (edge_mask > 0.5)[..., None]
    zero = torch.zeros(())
    act = torch.where(valid, torch.nn.functional.silu(pre), zero).to(torch.bfloat16).float()
    cols = (torch.arange(0, c, SLICE_K_BF16)[:, None] + torch.tensor(BUILD_ORDER)).reshape(-1)
    m2 = torch.nn.functional.silu(act[..., cols] @ decode_bf16_weight(prepared.w1, c).t() + b_l1)
    gate = torch.sigmoid((m2 * w_att).sum(-1, keepdim=True) + b_att)
    m2g = m2 * gate
    agg = torch.where(valid, m2g, zero).sum(-2)
    if coord_params is None:
        return agg
    _, b_c0, w_c1 = coord_params
    cw = torch.nn.functional.silu(
        m2g.to(torch.bfloat16).float() @ decode_bf16_weight(prepared.wc, c).t() + b_c0)
    wgt = (cw * w_c1).sum(-1, keepdim=True).clamp(-2.0, 2.0)
    return agg, torch.where(valid, wgt * egeo[..., et.G_CD:et.G_CD + 3], zero).sum(-2)


@pytest.mark.parametrize("coord", [False, True])
def test_bf16_kernel_inputs_match_plain(coord):
    """The bf16 mode's input preparation: the kernel's data path, emulated
    on the CPU from `prepare_layer`'s tables and weights and a bf16 B,
    against fused_edge_layer_plain(dtype=bf16) on the float32 arguments:
    agg within 1e-5 of its largest (float32 sums in another order), the
    coord update within BF16_LAYER_REL (those sums, in another order, may
    tip m2g's rounding to bf16 by one step; a wrong layout lands O(1)
    away); the tables are T_sp's then T_p's rows rounded to bf16; the wrapper
    gives the same bits for a bf16 B as for the float32 B it rounds; the
    float32 mode's tables are T_sp's then T_p's rows as they are."""
    b, pos, idx, mask, tab = graph(20, 12, 64, 3)
    n, k = idx.shape
    g = torch.Generator().manual_seed(2)
    c = 64
    r = lambda *s, scale=0.2: torch.randn(s, generator=g) * scale
    idx_t, mask_t, ebin, egeo = port_table(tab, n, k)
    a, B = r(1, n, c), r(1, n, c)
    t_sp, t_p, w_r = r(100, c, scale=0.3), r(66, c, scale=0.3), r(c, scale=0.01)
    w_l1, b_l1, w_att, b_att = r(c, c, scale=c ** -0.5), r(c), r(c, scale=c ** -0.5), r(1)
    coord_params = (r(c, c, scale=c ** -0.5), r(c), r(c, scale=c ** -0.5)) if coord else None
    prepared = prepare_layer(t_sp, t_p, w_l1, coord_params[0] if coord else None,
                             torch.bfloat16)
    assert prepared.tables.shape == (TABLE_ROWS, c) and prepared.tables.dtype == torch.bfloat16
    assert torch.equal(prepared.tables[:100], t_sp.to(torch.bfloat16))
    assert torch.equal(prepared.tables[100:], t_p.to(torch.bfloat16))
    assert (prepared.wc is None) == (not coord)
    args = (idx_t, mask_t, ebin, egeo, a, B, t_sp, t_p, w_r, w_l1, b_l1, w_att, b_att,
            coord_params)
    ref = fused_edge_layer_plain(*args, dtype=torch.bfloat16)
    B16 = B.to(torch.bfloat16)
    out = emulate_bf16_kernel(idx_t, mask_t, ebin, egeo, a, B16, w_r, b_l1, w_att, b_att,
                              prepared, coord_params)
    via16 = fused_edge_layer(*args[:5], B16, *args[6:], dtype=torch.bfloat16,
                             prepared=prepared)
    for o, rf, v, tol in zip(*((x if coord else (x,)) for x in (out, ref, via16)),
                             (1e-5, BF16_LAYER_REL)):
        assert (o - rf).abs().max() <= tol * rf.abs().max()
        assert torch.equal(v, rf)
    f32 = prepare_layer(t_sp, t_p, w_l1, coord_params[0] if coord else None)
    assert f32.tables.dtype == torch.float32 and torch.equal(f32.tables, torch.cat([t_sp, t_p]))
    assert torch.equal(f32.w1, prepare_weight(w_l1))


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_fused_weights_built_once_and_rebuilt_on_update(dtype):
    """egnn_apply_fused's step-invariant weights: under no_grad built once
    per set of weights (the same object on the next forward, its output
    bit-equal to a forward that builds them inline, with gradients on), and
    rebuilt when a parameter changes in place; the kernel-side form is
    prepare_layer's."""
    b, pos, idx, mask, tab = graph(20, 12, 64, 3)
    n, k = idx.shape
    layers = [EGCL(C, E_DIM, False), EGCL(C, E_DIM, True)]
    g = torch.Generator().manual_seed(4)
    sp_w, rp_w = torch.randn((100, E_DIM), generator=g), torch.randn((66, E_DIM), generator=g)
    h = torch.randn((1, n, C), generator=g)
    ca = torch.from_numpy(np.array(pos[:, 1, :]))[None]
    table = port_table(tab, n, k)
    node_mask = torch.from_numpy(np.array(b["node_mask"]))
    lig = torch.from_numpy(np.array(b["lig_mask"], np.float32))
    run = lambda: egnn_apply_fused(layers, sp_w, rp_w, h, ca, *table, node_mask, lig, dtype)
    with torch.no_grad():
        out = run()
        built = [layer._fused_weights[1] for layer in layers]
        again = run()
        assert all(layer._fused_weights[1] is w for layer, w in zip(layers, built))
    with torch.enable_grad():
        inline = run()
    for x, y, z in zip(out, again, inline):
        assert torch.equal(x, y) and torch.equal(x, z.detach())
    with torch.no_grad():
        layers[1].edge_mlp["l1"].weight.mul_(1.5)
        changed = run()
        assert layers[1]._fused_weights[1] is not built[1]
        assert layers[0]._fused_weights[1] is built[0]
    with torch.enable_grad():
        fresh = run()
    assert not torch.equal(changed[0], out[0])
    for x, y in zip(changed, fresh):
        assert torch.equal(x, y.detach())
    w = fused_weights(layers[1], sp_w, rp_w, dtype, kernel=True)
    ref = prepare_layer(w["t_sp"], w["t_p"], w["w_l1"], w["w_c0"], dtype)
    for x, y in zip(w["kernel"], ref):
        assert (x is None and y is None) or torch.equal(x, y)
