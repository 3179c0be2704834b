"""scripts/dfmdock_witness.py's CPU-draw sides make the `port` side's own
draws: with the CPU as their device and the eager route, a sweep of two
complexes (the generator running on from one to the next) gives the `port`
side's rows bit for bit.  This is what lets the card's run with the CPU
generator's draws be compared with the CPU run pose for pose (ROADMAP F4).
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "scripts"))
import dfmdock_witness as witness  # noqa: E402


def test_cpu_draws_side_repeats_the_port_sides_draws():
    ids, seed, poses, steps = ["1ZHI", "2SNI"], 6, 2, 1
    want = witness.port_side(ids, seed, poses, steps, "port")
    got = witness.port_cpu_draws_side(ids, seed, poses, steps, exact=True, device="cpu")
    assert sorted(got) == sorted(want) == sorted(ids)
    for cid in ids:
        np.testing.assert_array_equal(got[cid], want[cid], err_msg=cid)
