"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips without an NVIDIA card.  The
file imports neither JAX nor the JAX package, so that the machine with the
card, which has no JAX, runs it without the suite's conftest:

  python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerances: f32 rel 1e-4 of the largest plain value for sums (the kernels
add in their own order); exact for indices and bins, which are selections
and comparisons of the same values.
"""
import math
import os

import numpy as np
import pytest
import torch

from dfmdock_tpu_torch.config import SamplerConfig
from dfmdock_tpu_torch.data.batching import pad_complex
from dfmdock_tpu_torch.data.convert import load_npz_complex
from dfmdock_tpu_torch.data.dataset import batch_to_tensors, complex_to_batch
from dfmdock_tpu_torch.features.positional import NUM_RELPOS_CLASSES
from dfmdock_tpu_torch.features.sixd import SPATIAL_DIM, pairwise_ca_dist, sixd_values_at
from dfmdock_tpu_torch.models.edges import sample_gumbel, select_edges, select_y
from dfmdock_tpu_torch.ops import edge_table as et
from dfmdock_tpu_torch.ops.energy_head import fused_energy, fused_energy_plain
from dfmdock_tpu_torch.ops.fused_egcl import (
    fused_edge_layer,
    fused_edge_layer_plain,
    prepare_layer,
)
from dfmdock_tpu_torch.ops.select_topk import select_topk, select_topk_plain
from dfmdock_tpu_torch.sampler.em import randomize_pose

NPZ = os.path.join(os.path.dirname(__file__), "..", "data", "db5_npz", "1AVX.npz")

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels run only there")
    return torch.device("cuda")


def chain_dist(n_tot, seed, with_ties=False):
    rng = np.random.RandomState(seed)
    ca = np.cumsum(rng.randn(n_tot, 3) * 2 + [3.8, 0, 0], axis=0)
    d = np.linalg.norm(ca[:, None] - ca[None, :], axis=-1).astype(np.float32)
    return np.round(d / 4.0) * 4.0 if with_ties else d


def interface_mask(p, n, rng):
    """Receptor rows 0..n/2 x ligand columns n/2..7n/8 within 20 A, the two
    proteins balls of CAs (radius 25 and 20 A) whose centres lie 28 A apart
    (~2% of the pairs kept), padding after."""
    half, end = n // 2, 7 * n // 8

    def ball(k, radius):
        v = rng.randn(k, 3)
        return v / np.linalg.norm(v, axis=1, keepdims=True) * radius * rng.rand(k, 1) ** (1 / 3)

    ca = np.zeros((n, 3))
    ca[:half], ca[half:end] = ball(half, 25.0), ball(end - half, 20.0) + [28.0, 0, 0]
    d = np.linalg.norm(ca[:, None] - ca[None], axis=-1)
    rec, lig = np.arange(n) < half, (np.arange(n) >= half) & (np.arange(n) < end)
    return np.repeat((rec[:, None] & lig[None, :] & (d < 20.0))[None], p, axis=0)


@pytest.mark.parametrize("mask_kind,c", [("dense30", 256),    # 30% of all pairs
                                         ("interface", 256),  # as the dock's
                                         ("interface", 1024)])
def test_fused_energy(dev, mask_kind, c):
    """The kernel against fused_energy_plain: rel 1e-4, the all-masked pose
    exactly 0, two launches bit-equal."""
    rng = np.random.RandomState(5)
    p, n = 4, 448
    hr, hl = (torch.from_numpy(rng.randn(p, n, c).astype(np.float32)).to(dev) for _ in "ab")
    m = rng.rand(p, n, n) < 0.3 if mask_kind == "dense30" else interface_mask(p, n, rng)
    mask = torch.from_numpy(m.astype(np.float32)).to(dev)
    mask[-1] = 0.0
    g, b, w2 = (torch.from_numpy((s * rng.randn(c) + o).astype(np.float32)).to(dev)
                for s, o in ((0.3, 1.0), (0.1, 0.0), (0.1, 0.0)))
    before = fused_energy.launches
    out = fused_energy(hr, hl, mask, g, b, w2)
    ref = fused_energy_plain(hr, hl, mask, g, b, w2)
    again = fused_energy(hr, hl, mask, g, b, w2)
    torch.cuda.synchronize()
    assert fused_energy.launches == before + 2
    assert (out - ref).abs().max() <= 1e-4 * ref.abs().max()
    assert float(out[-1]) == 0.0
    assert torch.equal(out, again)  # no atomics: the same bits each run


@pytest.mark.parametrize("n_tot,n_valid,ties,sample_size", [
    pytest.param(448, 395, False, 40, id="448-395-False"),
    pytest.param(128, 128, True, 40, id="128-128-True"),
    pytest.param(64, 25, False, 40, id="64-25-False"),
    pytest.param(128, 100, False, 40, id="128-100-False"),  # padded
    pytest.param(96, 96, True, 0, id="96-96-True-s0"),  # kNN alone, forced ties
    # the sweep's buckets, with and without sampling
    pytest.param(512, 395, False, 40, id="512-395-s40"),
    pytest.param(512, 395, False, 0, id="512-395-s0"),
    pytest.param(768, 700, False, 40, id="768-700-s40"),
    pytest.param(768, 700, False, 0, id="768-700-s0"),
    # the widest rows the kernel takes (68 KB of shared memory a block)
    pytest.param(4096, 4000, False, 40, id="4096-4000-s40"),
])
def test_select_topk(dev, n_tot, n_valid, ties, sample_size):
    """The default select_edges launches the kernel and equals
    select_topk_plain on the same keys, forced ties included."""
    poses = (1,) if n_tot > 1024 else (1, 2)
    dist = torch.from_numpy(np.stack([chain_dist(n_tot, s, ties) for s in poses])).to(dev)
    node_mask = (torch.arange(n_tot) < n_valid).to(dev)
    before = select_topk.launches
    idx_k, em_k = select_edges(dist, node_mask, sample_size=sample_size,
                               generator=torch.Generator(dev).manual_seed(0))
    # the keys select_edges built, from the same generator draw
    y = select_y(dist, node_mask,
                 sample_gumbel(dist.shape, torch.Generator(dev).manual_seed(0), dev))
    if sample_size == 0:
        y = torch.zeros_like(dist)
    idx_k2, _ = select_topk(dist, y, node_mask, sample_size=sample_size)
    idx_p, em_p = select_topk_plain(dist, y, node_mask, sample_size=sample_size)
    torch.cuda.synchronize()
    assert select_topk.launches == before + 2
    assert torch.equal(idx_k, idx_p) and torch.equal(em_k, em_p) and torch.equal(idx_k2, idx_p)


def misaligned(t):
    """A contiguous copy of t whose data starts 4 bytes past 16."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 16 == 4
    return out


def test_misaligned_views(dev):
    """Contiguous views that start off 16 bytes (the kernels' float4 loads)
    give the same bits as aligned ones, in both redesigned kernels."""
    rng = np.random.RandomState(9)
    p, n, c = 2, 128, 256
    hr, hl = (torch.from_numpy(rng.randn(p, n, c).astype(np.float32)).to(dev) for _ in "ab")
    mask = torch.from_numpy((rng.rand(p, n, n) < 0.1).astype(np.float32)).to(dev)
    g, b, w2 = (torch.from_numpy(rng.randn(c).astype(np.float32)).to(dev) for _ in "abc")
    args = (hr, hl, mask, g, b, w2)
    out = fused_energy(*args)
    shifted = fused_energy(*map(misaligned, args))
    dist = torch.from_numpy(np.stack([chain_dist(n, s) for s in (1, 2)])).to(dev)
    node_mask = (torch.arange(n) < 120).to(dev)
    y = select_y(dist, node_mask,
                 sample_gumbel(dist.shape, torch.Generator(dev).manual_seed(0), dev))
    idx, em = select_topk(dist, y, node_mask)
    idx_s, em_s = select_topk(misaligned(dist), misaligned(y), node_mask)
    torch.cuda.synchronize()
    assert torch.equal(out, shifted)
    assert torch.equal(idx, idx_s) and torch.equal(em, em_s)


def test_edge_bins(dev):
    rng = np.random.RandomState(23)

    def chain(n, shift):
        ca = np.cumsum(rng.randn(n, 3) * 2 + [3.8, 0, 0], axis=0) + shift
        return np.stack([ca + rng.randn(n, 3) * 0.3 + [-1.2, 0.6, 0.2], ca,
                         ca + rng.randn(n, 3) * 0.3 + [1.3, 0.5, -0.2]], 1).astype(np.float32)

    b = pad_complex(rng.randn(70, 8).astype(np.float32), rng.randn(50, 8).astype(np.float32),
                    chain(70, np.zeros(3)), chain(50, np.array([10.0, 5.0, 0.0])))
    pos = torch.from_numpy(b["pos"])[None].to(dev)
    node_mask = torch.from_numpy(b["node_mask"]).to(dev)
    res_id, asym_id = (torch.from_numpy(b[k]).to(dev) for k in ("res_id", "asym_id"))
    dist = torch.cdist(pos[..., 1, :], pos[..., 1, :])
    idx, edge_mask = select_edges(dist, node_mask, generator=torch.Generator(dev).manual_seed(1))
    before = et.edge_bins.launches
    ebin = et.edge_bins(idx, pos, res_id, asym_id)
    table, _ = et.build_edge_table(idx, pos, res_id, asym_id, normalize=True)
    plain = et.edge_bins_plain(idx, pos, res_id, asym_id)
    torch.cuda.synchronize()
    assert et.edge_bins.launches == before + 1
    assert torch.equal(ebin, table)
    valid = edge_mask > 0.5
    assert torch.equal(ebin[valid], plain[valid])


@pytest.mark.parametrize("family", [0, 1, 2], ids=["dist", "angle", "phi"])
def test_bin_values_at_boundaries(dev, family):
    """The kernel's bin code (index arithmetic and its fix-up) against the
    plain count(x > b), exact: every boundary, its float32 neighbour on each
    side, NaN, +-inf, +-0 and values beyond either end."""
    b = np.array(et.BIN_FAMILIES[family], np.float32)
    x = np.concatenate([b, np.nextafter(b, np.float32(np.inf)),
                        np.nextafter(b, np.float32(-np.inf)),
                        np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e30, -1e30,
                                  b[0] - 100.0, b[-1] + 100.0], np.float32),
                        np.random.RandomState(family).uniform(-400, 400, 4096).astype(np.float32)])
    x_cpu = torch.from_numpy(x)
    before = et.bin_values.launches
    got = et.bin_values(x_cpu.to(dev), family).cpu()
    assert et.bin_values.launches == before + 1
    want = et.bin_values(x_cpu, family)  # the plain count on the CPU
    assert torch.equal(got, want)
    assert torch.equal(want[:len(b)], torch.arange(len(b), dtype=torch.int32))


def backbone(ca, rng):
    """N, CA, C of residues at the given CA positions, each a fixed
    template turned by its own random rotation."""
    tmpl = np.array([[-1.2, 0.6, 0.2], [0.0, 0.0, 0.0], [1.3, 0.5, -0.2]])
    q, _ = np.linalg.qr(rng.randn(len(ca), 3, 3))
    return (np.einsum("nij,aj->nai", q, tmpl) + ca[:, None, :]).astype(np.float32)


def test_bins_at_exact_distance_boundaries(dev):
    """CA distances that land exactly on 3.25 + 1.25 i (their squares and
    square roots are exact in float32) take bin i, as the plain count does:
    row 0 sits at the origin, rows 1..39 on the x axis at each boundary;
    every bin of every edge equal to plain."""
    rng = np.random.RandomState(31)
    n, k = 48, 40
    ca = rng.randn(n, 3) * 20.0
    ca[0] = 0.0
    ca[1:40] = [[d, 0.0, 0.0] for d in et.DIST_BOUNDARIES]
    pos = torch.from_numpy(backbone(ca, rng))[None].to(dev)
    idx = rng.randint(0, n, (1, n, k)).astype(np.int32)
    idx[0, 0] = np.r_[1:40, 0]  # row 0: every boundary, then itself
    idx = torch.from_numpy(idx).to(dev)
    res_id = torch.arange(n, dtype=torch.int32, device=dev)
    asym_id = (torch.arange(n, device=dev) >= 30).to(torch.int32)
    ebin = et.edge_bins(idx, pos, res_id, asym_id)
    table, _ = et.build_edge_table(idx, pos, res_id, asym_id, normalize=True)
    plain = et.edge_bins_plain(idx, pos, res_id, asym_id)
    torch.cuda.synchronize()
    assert torch.equal(ebin[0, 0, :39, et.E_DB].cpu(), torch.arange(39, dtype=torch.int32))
    assert torch.equal(ebin, table) and torch.equal(ebin, plain)


def poisoned(shape, dtype, dev):
    """Free a block of this size filled with a poison value just before the
    wrapper allocates its output, so a slot the kernel never writes shows
    (the caching allocator hands the freed block back)."""
    junk = torch.full(shape, -7, dtype=dtype, device=dev)
    del junk


@pytest.mark.parametrize("poses,n_rec,n_lig,pad_to,sample_size", [
    pytest.param(1, 223, 172, 448, 40, id="P1-K60"),   # one pose, K = 60
    pytest.param(2, 223, 172, 448, 0, id="P2-K20"),    # kNN alone, K = 20
    pytest.param(2, 24, 16, 64, 40, id="small-masked"),  # 40 valid of 64, K = 60
    pytest.param(40, 223, 172, 512, 40, id="P40-N512"),  # the DFMDock sweep's launch shape
])
def test_edge_table_rows(dev, poses, n_rec, n_lig, pad_to, sample_size):
    """The warp-per-row kernel on shapes that leave lanes of a warp idle:
    the bins-only mode equal to the table's ebin, relpos exact, the other
    bins equal to plain on valid edges except where plain's value lies
    within rounding of a boundary (1e-4 A, 1e-3 deg), geometry finite and
    within rel 1e-4 of plain, every slot written."""
    raw = load_npz_complex(NPZ)
    for side, n_keep in (("rec", n_rec), ("lig", n_lig)):
        for key in ("x", "pos", "seq"):
            raw[f"{side}_{key}"] = raw[f"{side}_{key}"][:n_keep]
    batch = batch_to_tensors(complex_to_batch(raw, pad_to=pad_to), dev)
    gen = torch.Generator(dev).manual_seed(poses + pad_to)
    pos, _, _ = randomize_pose(gen, batch["pos"], batch["lig_mask"], batch["node_mask"],
                               SamplerConfig(), poses)
    pos = pos.contiguous()
    idx, edge_mask = select_edges(pairwise_ca_dist(pos), batch["node_mask"],
                                  sample_size=sample_size, generator=gen)
    p, n, k = idx.shape
    assert k == 20 + sample_size
    args = (idx, pos, batch["res_id"], batch["asym_id"])
    poisoned((p, n, k, et.EBIN_WIDTH), torch.int32, dev)
    ebin = et.edge_bins(*args)
    poisoned((p, n, k, et.EBIN_WIDTH), torch.int32, dev)
    table, egeo = et.build_edge_table(*args, normalize=True)
    ref, geo_ref = et.build_edge_table_plain(*args, normalize=True)
    torch.cuda.synchronize()
    assert torch.equal(ebin, table)
    assert torch.equal(table[..., et.E_RP], ref[..., et.E_RP])
    dist, omega, theta, phi, _ = sixd_values_at(pos, idx)
    valid = edge_mask > 0.5
    near22 = (dist - 22.0).abs() < 1e-4
    for col, val, bounds, tol in ((et.E_DB, dist, et.DIST_BOUNDARIES, 1e-4),
                                  (et.E_OB, omega, et.ANGLE_BOUNDARIES, 1e-3),
                                  (et.E_TB, theta, et.ANGLE_BOUNDARIES, 1e-3),
                                  (et.E_PB, phi, et.PHI_BOUNDARIES, 1e-3)):
        b = torch.tensor(bounds, device=dev)
        near = (val[..., None] - b).abs().min(-1).values < tol
        if col != et.E_DB:
            near |= near22
        assert not ((table[..., col] != ref[..., col]) & valid & ~near).any(), col
    assert (table[..., et.E_DB] >= 0).all() and (table[..., et.E_DB] < 40).all()
    assert torch.isfinite(egeo).all()
    assert (egeo[valid] - geo_ref[valid]).abs().max() <= 1e-4 * geo_ref[valid].abs().max()


def egcl_inputs(dev, poses, n_rec, n_lig, pad_to, seed):
    """One EGCL layer's inputs at width 256 on random start poses of DB5 1AVX
    (its first n_rec / n_lig residues, padded to pad_to), the edges from the
    port's own selection and edge table; a masked edge's geometry is NaN."""
    raw = load_npz_complex(NPZ)
    for side, n_keep in (("rec", n_rec), ("lig", n_lig)):
        for key in ("x", "pos", "seq"):
            raw[f"{side}_{key}"] = raw[f"{side}_{key}"][:n_keep]
    batch = batch_to_tensors(complex_to_batch(raw, pad_to=pad_to), dev)
    gen = torch.Generator(dev).manual_seed(seed)
    pos, _, _ = randomize_pose(gen, batch["pos"], batch["lig_mask"], batch["node_mask"],
                               SamplerConfig(), poses)
    pos = pos.contiguous()
    idx, edge_mask = select_edges(pairwise_ca_dist(pos), batch["node_mask"], generator=gen)
    ebin, egeo = et.build_edge_table(idx, pos, batch["res_id"], batch["asym_id"],
                                     normalize=True)
    egeo = egeo.clone()
    egeo[edge_mask < 0.5] = float("nan")
    g = torch.Generator().manual_seed(seed)
    c, w = 256, 1.0 / math.sqrt(256)
    r = lambda *shape, scale=1.0: (torch.randn(shape, generator=g) * scale).to(dev)
    p, n = pos.shape[:2]
    args = (idx, edge_mask, ebin, egeo, r(p, n, c), r(p, n, c), r(SPATIAL_DIM, c, scale=0.3),
            r(NUM_RELPOS_CLASSES, c, scale=0.3), r(c, scale=0.01), r(c, c, scale=w),
            r(c, scale=0.1), r(c, scale=w), r(1, scale=0.1))
    return args, (r(c, c, scale=w), r(c, scale=0.1), r(c, scale=w))


def kernel_layer(args, coord_params=None, dtype=None):
    """fused_edge_layer's kernel on fused_edge_layer_plain's arguments, the
    layer's t_sp, t_p, w_l1 and w_c0 prepared for the mode first."""
    w_c0 = None if coord_params is None else coord_params[0]
    prepared = prepare_layer(args[6], args[7], args[9], w_c0, dtype)
    return fused_edge_layer(*args, coord_params, dtype=dtype, prepared=prepared)


@pytest.mark.parametrize("coord", [False, True])
@pytest.mark.parametrize("poses,n_rec,n_lig,pad_to", [(16, 223, 172, 448),  # the dock's shapes
                                                      (2, 24, 16, 64)])     # small, masked
def test_fused_egcl(dev, coord, poses, n_rec, n_lig, pad_to):
    """The tensor-core kernel against fused_edge_layer_plain: rel 1e-4 of
    the largest plain value (f32-grade three-pass bf16 products, another
    summation order), finite though masked geometry is NaN, and the same
    bits from two launches (no float atomics)."""
    args, coord_params = egcl_inputs(dev, poses, n_rec, n_lig, pad_to, seed=3)
    assert (args[1] < 0.5).any()
    extra = (coord_params,) if coord else ()
    counter = "coord_launches" if coord else "launches"
    before = getattr(fused_edge_layer, counter)
    out = kernel_layer(args, *extra)
    again = kernel_layer(args, *extra)
    ref = fused_edge_layer_plain(*args, *extra)
    torch.cuda.synchronize()
    assert getattr(fused_edge_layer, counter) == before + 2
    outs = out if coord else (out,)
    for o, o2, rf in zip(outs, again if coord else (again,), ref if coord else (ref,)):
        assert torch.isfinite(o).all()
        assert (o - rf).abs().max() <= 1e-4 * rf.abs().max()
        assert torch.equal(o, o2)


def test_fused_egcl_reads_prepared_weights(dev):
    """On CUDA tensors the kernel reads t_sp, t_p, w_l1 and w_c0 from
    `prepared` alone: a call without it raises rather than preparing them."""
    args, coord_params = egcl_inputs(dev, 1, 24, 16, 64, seed=3)
    for dtype in (None, torch.bfloat16):
        with pytest.raises(ValueError, match="prepared"):
            fused_edge_layer(*args, coord_params, dtype=dtype)


BF16_REL = 1e-3


def check_bf16_layer(args, coord_params, coord):
    """fused_edge_layer's bf16 mode on `args`: within BF16_REL of the
    largest plain value, finite, two launches bit-equal, counted."""
    extra = (coord_params,) if coord else ()
    counter = "bf16_coord_launches" if coord else "bf16_launches"
    before = getattr(fused_edge_layer, counter)
    out = kernel_layer(args, *extra, dtype=torch.bfloat16)
    again = kernel_layer(args, *extra, dtype=torch.bfloat16)
    ref = fused_edge_layer_plain(*args, *extra, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert getattr(fused_edge_layer, counter) == before + 2
    for o, o2, rf in zip(*((x if coord else (x,)) for x in (out, again, ref))):
        assert torch.isfinite(o).all()
        assert (o - rf).abs().max() <= BF16_REL * rf.abs().max()
        assert torch.equal(o, o2)
    return out


@pytest.mark.parametrize("coord", [False, True])
@pytest.mark.parametrize("poses,n_rec,n_lig,pad_to", [(16, 223, 172, 448),  # the dock's
                                                      (2, 24, 16, 64),      # small, masked
                                                      (4, 64, 40, 128),     # the parity
                                                      (4, 130, 100, 256),   # matrix's
                                                      (4, 223, 172, 640)])  # buckets
def test_fused_egcl_bf16(dev, coord, poses, n_rec, n_lig, pad_to):
    """The single-pass bf16 mode against fused_edge_layer_plain(dtype=bf16):
    both round the same values to bf16 (round to nearest), so they differ
    where the float32 sums ahead of a rounding, in another order, or the
    kernel's fast-math silu tip a value across a bf16 rounding boundary
    (one bf16 step on that element).  Within BF16_REL of the largest plain
    value (a CPU emulation, silu perturbed by 2e-7 of itself at the dock's
    shapes, moves the outputs by <= 9.5e-5 of their largest; the float32
    mode lies ~3e-3 away); finite though masked geometry is NaN; two
    launches bit-equal; counted as bf16 launches."""
    args, coord_params = egcl_inputs(dev, poses, n_rec, n_lig, pad_to, seed=3)
    check_bf16_layer(args, coord_params, coord)


def first_nodes(args, n_keep):
    """The layer's inputs cut to the first n_keep nodes of each pose, the
    edges to a dropped node masked (idx 0, geometry NaN)."""
    idx, edge_mask, ebin, egeo, a, B, *rest = args
    idx, edge_mask = idx[:, :n_keep].clone(), edge_mask[:, :n_keep].clone()
    gone = idx >= n_keep
    idx[gone], edge_mask[gone] = 0, 0.0
    egeo = egeo[:, :n_keep].clone()
    egeo[gone] = float("nan")
    return (idx, edge_mask, ebin[:, :n_keep].contiguous(), egeo,
            a[:, :n_keep].contiguous(), B[:, :n_keep].contiguous(), *rest)


@pytest.mark.parametrize("coord", [False, True])
@pytest.mark.parametrize("poses,n_keep,k", [
    (1, 63, 60),    # an odd node count: the last pair half empty
    (3, 63, 60),    # 189 nodes: 95 pairs, the last one half empty
    (2, 64, 20),    # K = 20 < 64
    (7, 63, 33),    # both at once
])
def test_fused_egcl_bf16_edge_cases(dev, coord, poses, n_keep, k):
    """The bf16 mode where its design could go wrong: a last node pair
    that is half empty, K below the 64-row tile, masked rows, and a node
    whose every edge is masked (its agg and trans exactly 0)."""
    args, coord_params = egcl_inputs(dev, poses, 24, 16, 64, seed=5)
    args = first_nodes(args, n_keep)
    idx, edge_mask, ebin, egeo = (t[:, :, :k].contiguous() for t in args[:4])
    edge_mask[0, 3] = 0.0
    egeo[0, 3] = float("nan")
    args = (idx, edge_mask, ebin, egeo, *args[4:])
    assert (edge_mask[:, :, :k] < 0.5).any() and (edge_mask > 0.5).any()
    out = check_bf16_layer(args, coord_params, coord)
    for o in (out if coord else (out,)):
        assert torch.equal(o[0, 3], torch.zeros_like(o[0, 3]))


@pytest.mark.parametrize("coord,pad_to", [(False, 512), (True, 448)], ids=["agg-N512", "coord-N448"])
def test_fused_egcl_forty_poses(dev, coord, pad_to):
    """40 poses a launch: the DFMDock lineage's agg-only layers at the
    sweep's bucket N = 512, and Picard's one forward over T = 40 poses
    (the coord layer) at N = 448; rel 1e-4 of the largest plain value,
    finite, two launches bit-equal."""
    args, coord_params = egcl_inputs(dev, 40, 223, 172, pad_to, seed=7)
    extra = (coord_params,) if coord else ()
    out = kernel_layer(args, *extra)
    again = kernel_layer(args, *extra)
    ref = fused_edge_layer_plain(*args, *extra)
    torch.cuda.synchronize()
    pairs = zip(out, again, ref) if coord else [(out, again, ref)]
    for o, o2, rf in pairs:
        assert torch.isfinite(o).all()
        assert (o - rf).abs().max() <= 1e-4 * rf.abs().max()
        assert torch.equal(o, o2)


def test_select_topk_forty_poses(dev):
    """select_topk at the DFMDock sweep's launch shape: 40 random poses of
    1AVX padded to N = 512, 20 + 40 edges, equal to the plain version."""
    batch = batch_to_tensors(complex_to_batch(load_npz_complex(NPZ), pad_to=512), dev)
    gen = torch.Generator(dev).manual_seed(40)
    pos, _, _ = randomize_pose(gen, batch["pos"], batch["lig_mask"], batch["node_mask"],
                               SamplerConfig(), 40)
    dist = pairwise_ca_dist(pos.contiguous())
    y = select_y(dist, batch["node_mask"], sample_gumbel(dist.shape, gen, dev))
    before = select_topk.launches
    idx_k, em_k = select_topk(dist, y, batch["node_mask"])
    idx_p, em_p = select_topk_plain(dist, y, batch["node_mask"])
    torch.cuda.synchronize()
    assert select_topk.launches == before + 1
    assert torch.equal(idx_k, idx_p) and torch.equal(em_k, em_p)
