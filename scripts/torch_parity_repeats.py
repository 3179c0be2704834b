"""chip_smoke.py's phase 4 case as the first work of many fresh processes.

    python3 scripts/torch_parity_repeats.py [--runs 24]

The case: ScoreNet through the float32 kernel route
(ModelConfig.fast(compute_dtype="float32"), seeded weights,
full width) on 1AVX padded to N = 448, its native pose and one random pose,
on injected edges, t = 0.1, against the plain path on the CPU (chip_smoke's
`parity_inputs`, `parity_errors` and tolerances).  This process builds the
kernels, makes the inputs and the CPU reference once and saves them; then
it starts `--runs` fresh processes one after another.  Each moves the
inputs and the model to the card and runs the kernel-path forward as its
first work on the card, prints every output's max abs and rel error, and
relaunches each kernel call of that forward on its recorded inputs
(chip_smoke's `diagnose_kernels`: the forward's output against a relaunch,
bit for bit, two relaunches, the plain version).  The summary gives, per
output, the largest error over the runs, how many runs failed, and every
kernel call whose output in the forward was not what a relaunch gives.
Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from dfmdock_tpu_torch.cli.common import load_model  # noqa: E402
from dfmdock_tpu_torch.config import DFMDockConfig, ModelConfig  # noqa: E402
from dfmdock_tpu_torch.data.convert import load_npz_complex  # noqa: E402
from dfmdock_tpu_torch.ops import _build  # noqa: E402

CFG = DFMDockConfig(model=ModelConfig.fast(compute_dtype="float32"))
T = 0.1


def reference(path):
    """The case's inputs and the plain-path outputs (CPU), saved to `path`."""
    device = torch.device("cuda")
    raw = load_npz_complex(os.path.join(ROOT, cs.NPZ))
    batch, pos, edges, _ = cs.parity_inputs(raw, device)
    cpu = lambda d: {k: v.cpu() for k, v in d.items()}
    net_p = load_model(None, CFG, torch.device("cpu"))
    with torch.no_grad():
        ref = net_p(cpu(batch), pos.cpu(), T, edges=tuple(e.cpu() for e in edges))
    torch.save({"batch": cpu(batch), "pos": pos.cpu(), "edges": tuple(e.cpu() for e in edges),
                "ref": ref}, path)


def child(path):
    """One fresh process: the kernel-path forward first, then diagnostics."""
    case = torch.load(path)
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    net_k = load_model(None, CFG, device)
    batch = {k: v.to(device) for k, v in case["batch"].items()}
    edges = tuple(e.to(device) for e in case["edges"])
    with torch.no_grad(), cs.recording_kernels() as calls:
        out = net_k(batch, case["pos"].to(device), T, edges=edges)
        torch.cuda.synchronize()
    errs = cs.parity_errors(cs.SCORE_NET_OUTPUTS, out, case["ref"])
    rows = cs.diagnose_kernels(calls)
    print(json.dumps({"errors": errs, "kernels": rows}))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--runs", type=int, default=24)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_parity_repeats: CUDA is not available", file=sys.stderr)
        return 2
    if args.child:
        child(args.child)
        return 0
    cs.device_phase()
    _build.build(*cs.BUILD)
    worst, failed, faults = {}, 0, []
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "case.pt")
        reference(path)
        for run in range(args.runs):
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", path],
                                  capture_output=True, text=True, timeout=300, cwd=ROOT)
            if proc.returncode != 0:
                print(proc.stdout[-4000:], proc.stderr[-4000:], sep="\n")
                raise SystemExit(f"run {run}: exit {proc.returncode}")
            res = json.loads(proc.stdout.strip().splitlines()[-1])
            ok = all(e[2] for e in res["errors"].values())
            failed += not ok
            for name, (a_err, r_err, _) in res["errors"].items():
                worst[name] = max(worst.get(name, (0.0, 0.0)), (r_err, a_err))
            bad = [r for r in res["kernels"]
                   if not (r["recorded_is_relaunch"] and r["relaunches_equal"])]
            faults += [(run, r) for r in bad]
            print(f"# run {run}: {'ok' if ok else 'FAIL'} in {time.perf_counter() - t0:.1f} s; "
                  + ", ".join(f"{k} abs {v[0]:.3e} rel {v[1]:.3e}"
                              for k, v in res["errors"].items())
                  + f"; kernel calls {len(res['kernels'])}, not reproduced by a relaunch "
                  f"{len(bad)}, worst kernel rel vs plain "
                  f"{max(r['plain_rel'] for r in res['kernels']):.3e}", flush=True)
    print(f"# {args.runs} fresh processes: {failed} failed phase 4's tolerances; worst "
          + ", ".join(f"{k} rel {v[0]:.3e} (abs {v[1]:.3e})" for k, v in worst.items())
          + f"; kernel outputs not reproduced by a relaunch: {len(faults)}")
    for run, r in faults:
        print(f"#   run {run}: {r}")
    return 1 if failed or faults else 0


if __name__ == "__main__":
    sys.exit(main())
