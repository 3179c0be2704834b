"""ROADMAP F6: does a training run repeat bit for bit on the card?

    python3 scripts/torch_f6_repeats.py   # one CUDA card, ~3 min

Runs chip_smoke.py's 9h protocol (the DFMDock lineage's training CLI at
crop 448, --grad-energy, the held-out complexes excluded, 2 epochs = 80
steps, through the captured step) twice as it is, then twice under
torch.use_deterministic_algorithms, and prints for each pair how many of
the trained weight arrays differ and by how much, and the ops that warned
of no deterministic path.  A reading, not a gate.
"""
from __future__ import annotations

import os
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from dfmdock_tpu_torch.cli import train  # noqa: E402


def gaps(a, b) -> str:
    """How far two trained nets' weights lie apart."""
    g = {k: float((a.state_dict()[k] - v).abs().max()) for k, v in b.state_dict().items()}
    differ = {k: x for k, x in g.items() if x > 0}
    return ("every trained weight bit-equal" if not differ else
            f"{len(differ)} of {len(g)} arrays differ, max abs {max(differ.values()):.3e} "
            f"({max(differ, key=differ.get)})")


def main():
    if not torch.cuda.is_available():
        print("torch_f6_repeats: CUDA is not available", file=sys.stderr)
        return 2
    os.chdir(ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.device_phase()
    with tempfile.TemporaryDirectory() as out:
        run = lambda tag: train.main(cs.DFMDOCK_TRAIN_FLAGS + [
            "--ckpt-dir", os.path.join(out, tag), "--device", "cuda"])["net"]
        a, b = run("a"), run("b")
        cs.log(f"# F6: 9h's training run twice: {gaps(a, b)}; card {smi}")
        with cs.deterministic(ops := set()):
            a, b = run("det_a"), run("det_b")
        cs.log(f"# F6: twice under torch.use_deterministic_algorithms: {gaps(a, b)}; ops "
               f"without a deterministic path: {'; '.join(sorted(ops)) or 'none warned'}; "
               f"card {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
