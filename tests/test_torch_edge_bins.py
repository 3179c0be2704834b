"""The port's bins-only edge table (ops/edge_table.edge_bins, the port of the
parked Pallas kernel ops/edge_bins.py) vs the JAX package: the plain version
against the Pallas edge_bins in interpret mode, on valid rows, with the
geometry of tests/test_parked_kernels.py, and against
build_edge_table_plain's ebin (the CUDA kernel against the edge_table
kernel's ebin is in test_torch_cuda_kernels.py).

Exact: every bin and relpos class (the Pallas kernel's polynomial atan is
~2e-7 rad off libm's, and no angle of this geometry lies that close to a
bin boundary, as tests/test_parked_kernels.py finds)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfmdock_tpu.features.sixd import pairwise_ca_dist, virtual_cb
from dfmdock_tpu.models.edges import select_edges as jax_select_edges
from dfmdock_tpu.ops.edge_bins import edge_bins as jax_edge_bins
from dfmdock_tpu_torch.ops import edge_table as et
from test_parked_kernels import _padded_batch


def neighbours(batch, kind):
    """idx [N, K]: 'ring' = K = 8 fixed offsets incl. self-edges over the
    valid nodes (as test_parked_kernels); 'selected' = kNN 20 + 40 sampled."""
    n = batch["pos"].shape[0]
    if kind == "ring":
        n_valid = int(np.asarray(batch["node_mask"]).sum())
        return ((jnp.arange(n)[:, None] + jnp.arange(8)[None, :] * 7) % n_valid).astype(jnp.int32)
    idx, _ = jax_select_edges(jax.random.PRNGKey(4), pairwise_ca_dist(batch["pos"]),
                              batch["node_mask"], knn=20, sample_size=40)
    return idx


@pytest.mark.parametrize("kind", ["ring", "selected"])
def test_plain_bins_match_jax_kernel(kind):
    batch = _padded_batch()
    idx = neighbours(batch, kind)
    ref = jax_edge_bins(idx, batch["pos"], virtual_cb(batch["pos"]), batch["res_id"],
                        batch["asym_id"])
    args = (torch.from_numpy(np.asarray(idx))[None], torch.from_numpy(np.asarray(batch["pos"]))[None],
            torch.from_numpy(np.asarray(batch["res_id"])),
            torch.from_numpy(np.asarray(batch["asym_id"])))
    ebin = et.edge_bins_plain(*args)[0].numpy()
    v = np.asarray(batch["node_mask"]).astype(bool)
    for col, want in zip((et.E_DB, et.E_OB, et.E_TB, et.E_PB, et.E_RP), ref):
        np.testing.assert_array_equal(ebin[v, :, col], np.asarray(want)[v], err_msg=str(col))
    table_ebin, _ = et.build_edge_table_plain(*args, normalize=True)
    np.testing.assert_array_equal(ebin, table_ebin[0].numpy())


def test_wrapper_on_cpu_runs_plain_and_counts_nothing():
    batch = _padded_batch()
    args = (torch.from_numpy(np.asarray(neighbours(batch, "ring")))[None],
            torch.from_numpy(np.asarray(batch["pos"]))[None],
            torch.from_numpy(np.asarray(batch["res_id"])),
            torch.from_numpy(np.asarray(batch["asym_id"])))
    before = et.edge_bins.launches
    assert torch.equal(et.edge_bins(*args), et.edge_bins_plain(*args))
    assert et.edge_bins.launches == before



@pytest.mark.parametrize("family,lo,hi,num_bins", [(0, 3.25, 50.75, 40), (1, -180.0, 180.0, 24),
                                                   (2, 0.0, 180.0, 12)],
                         ids=["dist", "angle", "phi"])
def test_bin_values_plain_matches_jax_at_boundaries(family, lo, hi, num_bins):
    """The plain bin count that the kernel's bin code (bin_values on the
    card) is held against equals the JAX package's _get_bins, exactly, at
    every boundary, its float32 neighbour on each side, NaN, +-inf and +-0;
    a CPU tensor runs it and counts no launch.  Subnormal neighbours (those
    of phi's boundary 0) are left out here: XLA's CPU backend flushes them
    to zero, PyTorch and the CUDA kernel do not (the cuda test holds the
    kernel to the plain count on them)."""
    from dfmdock_tpu.features.sixd import _get_bins

    b = np.array(et.BIN_FAMILIES[family], np.float32)
    x = np.concatenate([b, np.nextafter(b, np.float32(np.inf)), np.nextafter(b, np.float32(-np.inf)),
                        np.array([np.nan, np.inf, -np.inf, 0.0, -0.0], np.float32)])
    x = x[~((x != 0) & (np.abs(x) < np.finfo(np.float32).tiny))]
    before = et.bin_values.launches
    got = et.bin_values(torch.from_numpy(x), family).numpy()
    assert et.bin_values.launches == before
    np.testing.assert_array_equal(got, np.asarray(_get_bins(jnp.asarray(x), lo, hi, num_bins)))


def test_wrappers_refuse_other_devices():
    """A tensor on neither the CPU nor a CUDA card raises: no kernel, no
    plain fallback."""
    meta = lambda *shape, dtype=torch.float32: torch.empty(*shape, dtype=dtype, device="meta")
    idx = meta(1, 4, 2, dtype=torch.int32)
    args = (idx, meta(1, 4, 3, 3), meta(4, dtype=torch.int32), meta(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="no kernel"):
        et.build_edge_table(*args, normalize=True)
    with pytest.raises(ValueError, match="no kernel"):
        et.edge_bins(*args)
    with pytest.raises(ValueError, match="no kernel"):
        et.bin_values(meta(8), 0)
