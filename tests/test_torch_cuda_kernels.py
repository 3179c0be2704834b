"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips without an NVIDIA card.  The
file imports neither JAX nor the JAX package, so that the machine with the
card, which has no JAX, runs it without the suite's conftest:

  python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerances: f32 rel 1e-4 of the largest plain value for sums (the kernels
add in their own order); exact for indices and bins, which are selections
and comparisons of the same values.
"""
import numpy as np
import pytest
import torch

from dfmdock_tpu_torch.data.batching import pad_complex
from dfmdock_tpu_torch.models.edges import sample_gumbel, select_edges, select_y
from dfmdock_tpu_torch.ops import edge_table as et
from dfmdock_tpu_torch.ops.energy_head import fused_energy, fused_energy_plain
from dfmdock_tpu_torch.ops.select_topk import select_topk, select_topk_plain

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


def test_fused_energy(dev):
    rng = np.random.RandomState(5)
    p, n, c = 4, 448, 256
    hr, hl = (torch.from_numpy(rng.randn(p, n, c).astype(np.float32)).to(dev) for _ in "ab")
    mask = torch.from_numpy((rng.rand(p, n, n) < 0.3).astype(np.float32)).to(dev)
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


@pytest.mark.parametrize("n_tot,n_valid,ties", [(448, 395, False), (128, 128, True),
                                                (64, 25, False)])
def test_select_topk(dev, n_tot, n_valid, ties):
    dist = torch.from_numpy(np.stack([chain_dist(n_tot, s, ties) for s in (1, 2)])).to(dev)
    node_mask = (torch.arange(n_tot) < n_valid).to(dev)
    gen = torch.Generator(dev).manual_seed(0)
    idx_k, em_k = select_edges(dist, node_mask, generator=gen, kernel=True)
    # the select route's y, from the same generator draw
    y = select_y(dist, node_mask,
                 sample_gumbel(dist.shape, torch.Generator(dev).manual_seed(0), dev))
    before = select_topk.launches
    idx_k2, _ = select_topk(dist, y, node_mask)
    idx_p, em_p = select_topk_plain(dist, y, node_mask)
    torch.cuda.synchronize()
    assert select_topk.launches == before + 1
    assert torch.equal(idx_k, idx_p) and torch.equal(em_k, em_p) and torch.equal(idx_k2, idx_p)


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
