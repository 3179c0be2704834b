"""The port-trained db5_demo weights (ckpts/db5_demo_torch/weights.npz, the
record's 2000 epochs trained by the port's training CLI) hold exactly the
arrays of the JAX-trained ckpts/db5_demo/weights.npz, by key, shape and
dtype, and every value is finite."""
import os

import numpy as np

CKPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "ckpts")


def test_port_trained_demo_weights_match_the_record_layout():
    with np.load(os.path.join(CKPTS, "db5_demo", "weights.npz")) as ref, \
            np.load(os.path.join(CKPTS, "db5_demo_torch", "weights.npz")) as got:
        assert sorted(got.files) == sorted(ref.files)
        for k in ref.files:
            a, b = got[k], ref[k]
            assert (a.shape, a.dtype) == (b.shape, b.dtype), k
            assert np.isfinite(a).all(), k
