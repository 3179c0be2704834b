"""What sets the time of the port's fused_energy and select_topk kernels, on
one CUDA card.

    python3 scripts/torch_energy_breakdown.py

fused_energy runs on the inputs of the reranker dock's first energy call
(chip_smoke.py's ranking phase: DB5 1AVX, P = 16 poses, N = 448, C = 256)
under masks that keep the same inputs apart from what they test:

  dock            the mask as the dock gives it;
  rows shuffled   its rows permuted (the same pairs, other blocks);
  uniform         as many kept pairs, spread at random over all pairs;
  empty           nothing kept: the scan of the mask alone;
  dense 30%       30% of all pairs kept (the special-function units bind).

Each line gives the kept pairs, the device time per launch of every
kernel the wrapper starts (torch.profiler over 20 launches) and the error
against fused_energy_plain.  select_topk is timed on the dock's first
forward's distances (chip_smoke.py's seed-0 inputs) beside the two-torch.topk
route it replaced.  Prints the card's name and power limit first, then
ptxas's resource lines (`-Xptxas -v`) for every kernel of the two sources.
"""
from __future__ import annotations

import os
import re
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from dfmdock_tpu_torch.data.convert import load_npz_complex  # noqa: E402
from dfmdock_tpu_torch.ops import _build  # noqa: E402
from dfmdock_tpu_torch.ops.energy_head import fused_energy, fused_energy_plain  # noqa: E402
from dfmdock_tpu_torch.ops.select_topk import select_topk  # noqa: E402


def ptxas_lines(name):
    """ptxas's register and spill lines for each kernel of csrc/<name>.cu."""
    with tempfile.TemporaryDirectory() as tmp:
        flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
        log = subprocess.run([_build._nvcc(), *flags, "-Xptxas", "-v", "-c", "-o",
                              os.path.join(tmp, "k.o"), str(_build.CSRC / f"{name}.cu")],
                             capture_output=True, text=True, check=True).stderr
    out, kernel = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '_ZN\w*?_cu_[0-9a-f]{8}(\d+)(\w+)'", line)
        if m:  # the mangled name: its length, the name, then I Lb1 E for <true>
            n = int(m.group(1))
            kernel, rest = m.group(2)[:n], m.group(2)[n:]
            kernel += {"ILb1E": "<true>", "ILb0E": "<false>"}.get(rest[:5], "")
        elif kernel and ("registers" in line or "spill" in line):
            out.append(f"{kernel}: {line.strip()}")
    return out


def main():
    if not torch.cuda.is_available():
        print("torch_energy_breakdown: CUDA is not available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    for name in ("energy_head", "select_topk"):
        for line in ptxas_lines(name):
            print(f"# ptxas {line}")
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as out_root:
        _, args = cs.rank_phase(out_root)
    hr, hl, mask, g, b, w2 = args
    p, n, _ = mask.shape
    kept = mask != 0
    print(f"# dock mask: {int(kept.sum())} kept pairs, per pose "
          f"{kept.sum((-2, -1)).tolist()}, {int((kept.sum(-1) > 0).sum())} rows and "
          f"{int((kept.sum(-2) > 0).sum())} columns with a kept pair")
    gen = torch.Generator(dev).manual_seed(0)
    frac = float(kept.float().mean())
    masks = {
        "dock": mask,
        "rows shuffled": mask[:, torch.randperm(n, device=dev, generator=gen)].contiguous(),
        "uniform": (torch.rand(p, n, n, device=dev, generator=gen) < frac).float(),
        "empty": torch.zeros_like(mask),
        "dense 30%": (torch.rand(p, n, n, device=dev, generator=gen) < 0.3).float(),
    }
    for name, m in masks.items():
        a = (hr, hl, m, g, b, w2)
        _, rel, _ = cs.max_errs(fused_energy(*a), fused_energy_plain(*a))
        times = cs.device_ms(lambda: fused_energy(*a), calls=20, per_kernel=True)
        print(f"fused_energy {name}: {int((m != 0).sum())} kept, rel err {rel:.2e}, device "
              f"{sum(times.values()):.4f} ms = "
              + " + ".join(f"{k} {v:.4f}" for k, v in times.items()))
    raw = load_npz_complex(cs.NPZ)
    batch, pos, _, _ = cs.edge_inputs(raw, cs.N_PAD, cs.P, 0, dev)
    dist = cs.pairwise_ca_dist(pos)
    y = cs.select_y(dist, batch["node_mask"], cs.sample_gumbel(
        dist.shape, torch.Generator(dev).manual_seed(100), dev))
    sel = (dist, y, batch["node_mask"])
    for name, fn in (("select_topk", lambda: select_topk(*sel)),
                     ("two torch.topk", lambda: cs.select_topk_library(*sel))):
        times = cs.device_ms(fn, calls=20, per_kernel=True)
        print(f"{name}: device {sum(times.values()):.4f} ms = "
              + " + ".join(f"{k} {v:.4f}" for k, v in times.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
