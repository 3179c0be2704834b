"""The port's plain edge table (ops/edge_table.build_edge_table_plain, what
the CUDA kernel is held against on the card) vs the JAX package's Pallas
build_edge_table, run in interpret mode on the CPU as
tests/test_edge_table.py runs it."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
from dfmdock_tpu.features.sixd import pairwise_ca_dist
from dfmdock_tpu.models.edges import select_edges
from dfmdock_tpu.ops import fused_egcl as jf
from dfmdock_tpu.ops.edge_table import build_edge_table as jax_build_edge_table
from dfmdock_tpu_torch.ops import edge_table as et

BIN_COLS = {jf.R_DB: et.E_DB, jf.R_OB: et.E_OB, jf.R_TB: et.E_TB,
            jf.R_PB: et.E_PB, jf.R_RP: et.E_RP}
GEO_COLS = {jf.R_RAD: et.G_RAD, jf.R_CD: et.G_CD, jf.R_CD + 1: et.G_CD + 1,
            jf.R_CD + 2: et.G_CD + 2}


def tables(n_rec, n_lig, pad_to, seed, normalize=True):
    b = tp.padded(n_rec, n_lig, feat=8, seed=seed, pad_to=pad_to)
    pos = jnp.asarray(b["pos"])
    idx, mask = select_edges(jax.random.PRNGKey(seed), pairwise_ca_dist(pos),
                             jnp.asarray(b["node_mask"]), knn=20, sample_size=40)
    args = (idx, mask, pos, jnp.asarray(b["res_id"]), jnp.asarray(b["asym_id"]))
    t_j = np.asarray(jax_build_edge_table(*args, normalize=normalize))
    tb = tp.port_batch(b)
    ebin, egeo = et.build_edge_table(
        torch.from_numpy(np.array(idx))[None], tb["pos"][None], tb["res_id"],
        tb["asym_id"], normalize=normalize)
    return t_j, ebin[0].reshape(-1, et.EBIN_WIDTH).numpy(), egeo[0].reshape(-1, 4).numpy()


@pytest.mark.parametrize("n_rec,n_lig,pad_to,seed,normalize", [
    (20, 12, 64, 3, True),     # small graph: 32 valid nodes < K = 60
    (48, 30, 128, 5, True),
    (70, 50, 128, 7, False),
])
def test_plain_table_matches_jax_kernel(n_rec, n_lig, pad_to, seed, normalize):
    """On valid edges the bins are exact
    (the Pallas kernel's polynomial atan may flip a bin within ~1e-5 deg of
    a boundary: at most 1e-3 of the edges, as tests/test_edge_table.py
    allows) and the geometry within rtol 1e-5 / atol 1e-5 (f32); every
    output finite, masked edges included."""
    t_j, ebin, egeo = tables(n_rec, n_lig, pad_to, seed, normalize)
    valid = t_j[jf.R_MASK] > 0.5
    assert valid.sum() > 100
    for r, col in BIN_COLS.items():
        flips = ((ebin[:, col] != t_j[r]) & valid).sum()
        assert flips <= 1e-3 * valid.sum(), f"bin column {col}: {flips} flips"
    for r, col in GEO_COLS.items():
        np.testing.assert_allclose(egeo[valid, col], t_j[r][valid], rtol=1e-5,
                                   atol=1e-5, err_msg=f"geometry column {col}")
    assert np.isfinite(egeo).all()
    assert (ebin[:, et.E_DB] >= 0).all() and (ebin[:, et.E_DB] < 40).all()
    assert (ebin[:, et.E_RP] >= 0).all() and (ebin[:, et.E_RP] < 66).all()


def test_wrapper_on_cpu_runs_plain_and_counts_nothing():
    before = et.build_edge_table.launches
    tables(20, 12, 64, 3)
    assert et.build_edge_table.launches == before
