"""The pool path's schedule over a whole training protocol, held against the
JAX package on the CPU: the epochs at which the pool is rebuilt over the
DFMDock protocol's 800 epochs (two runs of 400, the second resumed, a
refresh every 25), and, as distributions, each epoch's permutation of the
pool rows and the rotation drawn for each visit of a row.

The two packages draw from different generators, so their draws are not
equal; each is held to the distribution it should follow by Pearson's
chi-square test at family-wise p = 1e-3 (Bonferroni over the tests of one
package's draws), from fixed seeds.
"""
import ast
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

import dfmdock_tpu.cli.train as jax_train
from dfmdock_tpu.train.pool import rotate_batch as jax_rotate_batch
from dfmdock_tpu_torch.cli import train
from dfmdock_tpu_torch.train.pool import PoolStep, rotate_batch

P_FAMILY = 1e-3
ROWS = 40  # the DFMDock protocol's pool: 20 training complexes x 2 variants
EPOCHS_DRAWN = 2000  # permutations drawn per package: 50 expected per cell
ROTATIONS = 3000
BINS = 20  # 150 expected per bin


def jax_refresh_epochs(epochs, pool_refresh, per_call, save_every=0):
    """The epochs at which the JAX CLI's pool loop builds its pool: its own
    condition (read from dfmdock_tpu/cli/train.py) checked at the start of
    each dispatch, whose length its `dispatch_chunk` sets."""
    with open(jax_train.__file__) as f:
        tree = ast.parse(f.read())
    cond, = (n.test for n in ast.walk(tree)
             if isinstance(n, ast.If) and "pool is None" in ast.unparse(n.test))
    code = compile(ast.Expression(cond), jax_train.__file__, "eval")
    args = types.SimpleNamespace(pool_refresh=pool_refresh)
    out, pool, epoch = [], None, 0
    while epoch < epochs:
        if eval(code, {}, {"pool": pool, "args": args, "epoch": epoch}):
            out.append(epoch)
            pool = object()
        epoch += jax_train.dispatch_chunk(epoch, epochs, per_call, pool_refresh, save_every)
    return out


def port_refresh_epochs(epochs, pool_refresh):
    """The same for the port's loop, one epoch at a time."""
    out, have = [], False
    for epoch in range(epochs):
        if train.refresh_pool(epoch, pool_refresh, have):
            out.append(epoch)
            have = True
    return out


@pytest.mark.parametrize("per_call", [1, 10])
def test_refresh_epochs_match_jax_over_the_protocol(per_call):
    """800 epochs as two runs of 400 (the second --resume'd, counting from 0
    again), --pool-refresh 25: the pool is built at the same epochs."""
    args = train.parse_args(["--epochs", "400"])
    assert args.pool_refresh == 25
    half = port_refresh_epochs(400, args.pool_refresh)
    assert half == jax_refresh_epochs(400, 25, per_call)
    protocol = half + [400 + e for e in half]
    assert protocol == list(range(0, 800, 25))
    # no refresh: built once per run; another period: the same on both sides
    assert port_refresh_epochs(400, 0) == jax_refresh_epochs(400, 0, per_call) == [0]
    assert port_refresh_epochs(90, 7) == jax_refresh_epochs(90, 7, per_call)


def uniform_rows_p(positions):
    """positions [epochs, rows]: the position of each row in each epoch's
    order.  The smallest p of the per-row chi-square tests of a uniform
    position, and the number of rows."""
    epochs, rows = positions.shape
    counts = np.stack([np.bincount(positions[:, r], minlength=rows) for r in range(rows)])
    return min(stats.chisquare(c).pvalue for c in counts), rows


def inverse(perms):
    """[epochs, rows] permutations (the row at each step) -> the step at
    which each row is visited."""
    return np.argsort(perms, axis=1)


def test_epoch_permutation_is_uniform():
    """Each pool row's step within the epoch, over EPOCHS_DRAWN epochs, is
    uniform over the ROWS steps, for PoolStep.start's draws and for the
    JAX epoch runner's (jax.random.permutation of the epoch key's first
    split), at family-wise P_FAMILY over the rows."""
    step = PoolStep(None, None, None, None, None, None, torch.Generator().manual_seed(12))
    step.load({"x": torch.zeros(ROWS, 1)})
    port = []
    for _ in range(EPOCHS_DRAWN):
        assert step.start() == ROWS
        port.append(step.perm.numpy().copy())
    keys = jax.random.split(jax.random.PRNGKey(12), EPOCHS_DRAWN)
    jperm = jax.vmap(lambda k: jax.random.permutation(jax.random.split(k)[0], ROWS))
    for name, perms in (("port", np.stack(port)), ("jax", np.asarray(jperm(keys)))):
        assert (np.sort(perms, 1) == np.arange(ROWS)).all(), name
        p, rows = uniform_rows_p(inverse(perms))
        assert p > P_FAMILY / rows, (name, p)


def haar_pvalues(R):
    """R [M, 3, 3] rotations: the chi-square p of the rotation angle against
    the Haar density (1 - cos t) / pi on [0, pi] and of the axis's z and
    azimuth against uniform, in BINS equiprobable bins each."""
    cos = np.clip((np.trace(R, axis1=1, axis2=2) - 1.0) / 2.0, -1.0, 1.0)
    theta = np.arccos(cos)
    axis = np.stack([R[:, 2, 1] - R[:, 1, 2], R[:, 0, 2] - R[:, 2, 0],
                     R[:, 1, 0] - R[:, 0, 1]], 1)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    # the angle's bins equiprobable under its CDF (t - sin t) / pi
    grid = np.linspace(0.0, np.pi, 100_001)
    edges = np.interp(np.linspace(0.0, 1.0, BINS + 1), (grid - np.sin(grid)) / np.pi, grid)
    out = {"angle": stats.chisquare(np.histogram(theta, edges)[0]).pvalue}
    for name, x, lo, hi in (("axis z", axis[:, 2], -1.0, 1.0),
                            ("axis azimuth", np.arctan2(axis[:, 1], axis[:, 0]), -np.pi, np.pi)):
        out[name] = stats.chisquare(np.histogram(x, np.linspace(lo, hi, BINS + 1))[0]).pvalue
    return out


def unit_batch():
    """Four valid rows whose CAs sit at e1, e2, e3 and -(e1 + e2 + e3): their
    centroid is 0, so the rotated CAs of the first three are R's columns."""
    ca = np.concatenate([np.eye(3), -np.ones((1, 3))]).astype(np.float32)
    pos = np.stack([ca + 0.5, ca, ca - 0.5], 1)
    return {"pos": pos, "node_mask": np.ones(4, bool)}


def test_visit_rotation_is_haar():
    """rotate_batch's rotation, read back from a batch whose CA centroid is
    0, against the Haar measure: its angle's density (1 - cos t) / pi and
    a uniform axis, ROTATIONS draws a package, at family-wise P_FAMILY over
    the three tests."""
    b = unit_batch()
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    gen = torch.Generator().manual_seed(3)
    port = np.stack([rotate_batch(tb, gen)["pos"][:3, 1].numpy().T for _ in range(ROTATIONS)])
    keys = jax.random.split(jax.random.PRNGKey(3), ROTATIONS)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jrot = jax.jit(jax.vmap(lambda k: jax_rotate_batch(jb, jax.random.split(k)[0])["pos"][:3, 1].T))
    for name, R in (("port", port), ("jax", np.asarray(jrot(keys)))):
        np.testing.assert_allclose(R @ R.transpose(0, 2, 1), np.broadcast_to(np.eye(3), R.shape),
                                   atol=1e-5, err_msg=name)
        assert np.allclose(np.linalg.det(R), 1.0, atol=1e-5), name
        pvals = haar_pvalues(R.astype(np.float64))
        assert min(pvals.values()) > P_FAMILY / len(pvals), (name, pvals)


def test_haar_test_rejects_a_wrong_density():
    """The angle test tells the Haar density from rotations about uniform
    axes by a uniform angle (the classic mistake)."""
    rng = np.random.default_rng(0)
    axis = rng.normal(size=(ROTATIONS, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    theta = rng.uniform(0.0, np.pi, ROTATIONS)
    k = np.zeros((ROTATIONS, 3, 3))
    k[:, 0, 1], k[:, 0, 2], k[:, 1, 2] = -axis[:, 2], axis[:, 1], -axis[:, 0]
    k = k - k.transpose(0, 2, 1)
    s, c = np.sin(theta)[:, None, None], np.cos(theta)[:, None, None]
    R = np.eye(3) + s * k + (1 - c) * k @ k
    pvals = haar_pvalues(R)
    assert pvals["angle"] < 1e-6 and pvals["axis z"] > P_FAMILY


def test_row_test_rejects_a_biased_order():
    """The per-row test tells uniform orders from orders that keep row 0
    first one epoch in ten."""
    rng = np.random.default_rng(1)
    perms = np.stack([rng.permutation(ROWS) for _ in range(EPOCHS_DRAWN)])
    for e in range(0, EPOCHS_DRAWN, 10):
        j = int(np.flatnonzero(perms[e] == 0)[0])
        perms[e, [0, j]] = perms[e, [j, 0]]
    p, rows = uniform_rows_p(inverse(perms))
    assert p < P_FAMILY / rows
