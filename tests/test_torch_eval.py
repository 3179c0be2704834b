"""The port's DockQ metrics (eval/metrics.py) against the JAX package's on
the same poses: DB5 1QA9's native ligand turned and moved by seeded
amounts, from on the site (DockQ 1) to well off it."""
import numpy as np
import pytest

from dfmdock_tpu.eval import compute_metrics as jax_compute_metrics
from dfmdock_tpu_torch.data.convert import load_npz_complex
from dfmdock_tpu_torch.eval import compute_metrics


@pytest.mark.parametrize("scale", [0.0, 0.5, 2.0, 8.0])
def test_metrics_match_jax(scale):
    raw = load_npz_complex("data/db5_npz/1QA9.npz")
    rec, lig = raw["rec_pos"], raw["lig_pos"]
    rng = np.random.default_rng(int(scale * 10))
    angle = rng.normal(size=3) * 0.1 * scale
    theta = np.linalg.norm(angle)
    k = np.cross(np.eye(3), angle / max(theta, 1e-12))
    rot = np.eye(3) + np.sin(theta) * k + (1.0 - np.cos(theta)) * k @ k
    center = lig.reshape(-1, 3).mean(0)
    moved = ((lig - center) @ rot.T + center + rng.normal(size=3) * scale).astype(np.float32)
    got = compute_metrics((rec, moved), (rec, lig))
    ref = jax_compute_metrics((rec, moved), (rec, lig))
    assert set(got) == set(ref)
    for key in ref:
        np.testing.assert_allclose(float(got[key]), float(ref[key]), rtol=1e-9, atol=1e-12,
                                   err_msg=key)
    if scale == 0.0:
        assert float(got["DockQ"]) == pytest.approx(1.0)
