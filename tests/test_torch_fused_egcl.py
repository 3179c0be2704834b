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
    SLICE_K,
    fused_edge_layer,
    fused_edge_layer_plain,
    prepare_weight,
    split_bf16,
)
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
    """The weight as the CUDA kernel streams it: element (out n, in k) of
    W^T at the offset the kernel's wgmma descriptors read (slice k // SLICE_K,
    8 x 8 core matrices, hi then lo piece; the single-pass mode's layout
    the hi pieces alone), hi the round-to-nearest bf16 of W and hi + lo
    within 2^-16 of W.  A three-pass product on the pieces
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
    # the single-pass mode streams the hi piece alone, in the same order
    assert torch.equal(prepare_weight(w, single=True), prepare_weight(w)[:, :1])
    x = torch.nn.functional.silu(torch.randn((64, c), generator=g) * 2.0)
    (xh, xl), (wh, wl) = split_bf16(x), split_bf16(w)
    d = lambda t: t.double()
    three = d(xh) @ d(wh) + d(xl) @ d(wh) + d(xh) @ d(wl)
    ref = x @ w
    assert (three - d(ref)).abs().max() <= 1e-4 * ref.abs().max()
