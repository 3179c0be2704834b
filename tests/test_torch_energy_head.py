"""The port's pair energy head (ops/energy_head) vs the JAX package: the plain
version against the Pallas fused_energy (interpret mode, as
tests/test_parked_kernels.py runs it) and the port's ScoreNet._energy on
both paths against the JAX ScoreNet._energy row-chunk scan (the CUDA
kernel against its plain version is in test_torch_cuda_kernels.py).

Tolerance: rel 1e-5 (f32 on both sides, summation order apart).  An
all-masked pose is exactly 0."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
from dfmdock_tpu.models import ScoreNet as JaxScoreNet
from dfmdock_tpu.ops.energy_head import fused_energy as jax_fused_energy
from dfmdock_tpu_torch.ops.energy_head import fused_energy, fused_energy_plain


def inputs(n=128, c=64, poses=2, seed=5):
    """hr, hl, pair masks (receptor rows 0..59 x ligand rows 60..99 at 40%
    density, padding from 100; the last pose all masked), a non-trivial LN
    affine and w2, as numpy."""
    rng = np.random.RandomState(seed)
    hr = rng.randn(poses, n, c).astype(np.float32)
    hl = rng.randn(poses, n, c).astype(np.float32)
    lig = np.zeros(n, np.float32)
    lig[60:100] = 1.0
    rec = np.zeros(n, np.float32)
    rec[:60] = 1.0
    mask = (rec[:, None] * lig[None, :] * (rng.rand(poses, n, n) < 0.4)).astype(np.float32)
    mask[-1] = 0.0
    g = (1.3 + 0.2 * rng.randn(c)).astype(np.float32)
    b = (0.05 + 0.1 * rng.randn(c)).astype(np.float32)
    w2 = (0.1 * rng.randn(c)).astype(np.float32)
    return hr, hl, mask, g, b, w2


def test_plain_matches_jax_kernel():
    hr, hl, mask, g, b, w2 = inputs()
    out = fused_energy_plain(*map(torch.from_numpy, (hr, hl, mask, g, b, w2))).numpy()
    for p in range(hr.shape[0]):
        ref = float(jax_fused_energy(hr[p], hl[p], mask[p], g, b, w2))
        np.testing.assert_allclose(out[p], ref, rtol=1e-5, atol=1e-7)
    assert out[-1] == 0.0  # the empty masked mean: 0 / (0 + 1e-6)


def test_plain_matches_jax_kernel_interface_mask():
    """An interface-shaped sparse mask, as the dock's: receptor rows x
    ligand columns within 20 A of two random-walk chains that touch, a few
    percent of the pairs kept, whole rows empty."""
    hr, hl, _, g, b, w2 = inputs(n=128, c=64, poses=3, seed=9)
    rng = np.random.RandomState(10)
    rec = np.cumsum(rng.randn(60, 3) * 2 + [3.8, 0, 0], axis=0)
    lig = np.cumsum(rng.randn(40, 3) * 2 + [0, 3.8, 0], axis=0) + rec[30] + [0, 0, 8.0]
    ca = np.zeros((128, 3))
    ca[:60], ca[60:100] = rec, lig
    is_rec, is_lig = np.arange(128) < 60, (np.arange(128) >= 60) & (np.arange(128) < 100)
    mask = np.zeros((3, 128, 128), np.float32)
    for p in range(2):
        d = np.linalg.norm(ca[:, None] - ca[None] + p * np.array([0, 0, 4.0]) * is_lig[None, :, None],
                           axis=-1)
        mask[p] = is_rec[:, None] & is_lig[None, :] & (d < 20.0)
    assert 0.0 < mask[0].mean() < 0.1 and not mask[0][60:].any()
    out = fused_energy_plain(*map(torch.from_numpy, (hr, hl, mask, g, b, w2))).numpy()
    for p in range(3):
        ref = float(jax_fused_energy(hr[p], hl[p], mask[p], g, b, w2))
        np.testing.assert_allclose(out[p], ref, rtol=1e-5, atol=1e-7)
    assert out[-1] == 0.0


@pytest.mark.parametrize("kernel_path", [False, True])
def test_score_net_energy_matches_jax(kernel_path):
    """ScoreNet._energy (the head's l0 split into hr / hl, then the kernel's
    plain version or the eager chunk loop) against JAX's row-chunk scan,
    with the LN affine moved off its (1, 0) init."""
    jc, pc = tp.configs()
    pc = dataclasses.replace(pc, use_pallas=kernel_path, edge_table_kernel=kernel_path)
    params = JaxScoreNet(jc).init(jax.random.PRNGKey(2))
    c = jc.node_dim
    rng = np.random.RandomState(8)
    ln = params["to_energy"]["ln"]
    params["to_energy"]["ln"] = {"g": ln["g"] * 1.3 + jnp.asarray(0.1 * rng.randn(c), jnp.float32),
                                 "b": ln["b"] + 0.05}
    _, _, mask, *_ = inputs(c=c)
    h = (rng.randn(2, 128, c) * 3).astype(np.float32)
    net = tp.port_net(pc, params)
    with torch.no_grad():
        out = net._energy(torch.from_numpy(h), torch.from_numpy(mask)).numpy()
    for p in range(2):
        ref = float(JaxScoreNet(jc)._energy(params["to_energy"], jnp.asarray(h[p]),
                                            jnp.asarray(mask[p])))
        np.testing.assert_allclose(out[p], ref, rtol=1e-5, atol=1e-7)


def test_wrapper_on_cpu_runs_plain_and_counts_nothing():
    before = fused_energy.launches
    args = tuple(map(torch.from_numpy, inputs()))
    torch.testing.assert_close(fused_energy(*args), fused_energy_plain(*args), rtol=0, atol=0)
    assert fused_energy.launches == before

