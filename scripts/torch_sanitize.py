"""Each CUDA source of dfmdock_tpu_torch under compute-sanitizer, at small shapes.

    python3 scripts/torch_sanitize.py [--tools memcheck,initcheck,racecheck,synccheck]

Builds the four sources of csrc/, then for each tool runs this script again
under `compute-sanitizer --tool <tool>` with `--launch`, which launches
every kernel once at small shapes and synchronizes: DB5 1AVX cut to 24
receptor and 16 ligand residues padded to N = 64 (24 masked rows), two
poses, K = 60: select_topk (40 samples), the edge table and its bins-only
mode, fused_egcl without and with the coord MLP, fused_energy on the
receptor x ligand mask within 20 A with the second pose all masked.  The
inputs are made first and the launches run last, so the kernels of this
package are the last ones in each log.

compute-sanitizer ships with the CUDA toolkit and needs no performance
counters.  memcheck finds out-of-bounds and misaligned accesses, initcheck
reads of device memory never written, racecheck shared-memory hazards
between threads of a block, synccheck misused barriers.  racecheck follows
the threads' own loads and stores to shared memory; the bulk copies and
mbarriers of fused_egcl.cu's W ring and the wgmma operand reads go through
the async proxy, which it may not model.

Prints, per tool, the sanitizer's exit code, its summary lines and the
report lines that name a kernel of this package; the whole logs go to
<--log-dir>/<tool>.log.  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import collections
import os
import shutil
import signal
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from dfmdock_tpu_torch.data.convert import load_npz_complex  # noqa: E402
from dfmdock_tpu_torch.ops import _build  # noqa: E402

TOOLS = ("memcheck", "initcheck", "racecheck", "synccheck")
KERNELS = ("select_topk_kernel", "edge_table_kernel", "fused_egcl_kernel", "energy_rows_kernel",
           "energy_reduce_kernel")


def launch():
    """Every kernel once at small shapes on the card (inputs first)."""
    device = torch.device("cuda")
    raw = load_npz_complex(os.path.join(ROOT, cs.NPZ))
    small = dict(raw)
    for key, n in (("rec_x", 24), ("rec_pos", 24), ("lig_x", 16), ("lig_pos", 16)):
        small[key] = raw[key][:n]
    small["rec_seq"], small["lig_seq"] = raw["rec_seq"][:24], raw["lig_seq"][:16]
    batch, pos, idx, edge_mask = cs.edge_inputs(small, 64, 2, 3, device)
    table = (idx, pos, batch["res_id"], batch["asym_id"])
    ebin, egeo = cs.build_edge_table_plain(*table, normalize=True)
    dist = cs.pairwise_ca_dist(pos)
    y = cs.select_y(dist, batch["node_mask"], cs.sample_gumbel(
        dist.shape, torch.Generator(device).manual_seed(1), device))
    layer, coord = cs.fused_inputs(idx, edge_mask, ebin, egeo, 256, 0, device)
    energy = cs.energy_inputs(batch, pos, 256, 0, device)
    torch.cuda.synchronize()
    print("# sanitize: inputs ready; launching", flush=True)
    out = {
        "select_topk": cs.select_topk(dist, y, batch["node_mask"], 20, 40),
        "edge_table": cs.build_edge_table(*table, normalize=True),
        "edge_bins": cs.edge_bins(*table),
        "fused_egcl": cs.kernel_layer(layer),
        "fused_egcl_coord": cs.kernel_layer(layer, coord),
        "fused_energy": cs.fused_energy(*energy),
    }
    torch.cuda.synchronize()
    print("# sanitize: launched " + ", ".join(out), flush=True)


def sanitizer() -> str:
    path = shutil.which("compute-sanitizer") or "/usr/local/cuda/bin/compute-sanitizer"
    if not os.path.exists(path):
        raise SystemExit(f"compute-sanitizer not found (looked for {path})")
    return path


def report(tool, rc, log):
    """The summary lines, and the report lines that name each kernel of
    this package (its own errors, and where the kernel is the site)."""
    lines = [l for l in log.splitlines() if l.startswith("=========")]
    summary = [l.strip("= ") for l in lines if "SUMMARY" in l]
    named = collections.Counter(k for l in lines for k in KERNELS if k in l)
    print(f"# {tool}: exit {rc}; " + (" | ".join(summary) or "no summary line") + "; "
          + (f"report lines naming this package's kernels: {dict(named)}" if named else
             "no report line names a kernel of this package"), flush=True)
    for l in lines[:40]:
        print(f"#   {l}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--tools", default=",".join(TOOLS))
    ap.add_argument("--timeout", type=int, default=420, help="seconds per tool")
    ap.add_argument("--log-dir", default=os.path.join(tempfile.gettempdir(), "torch_sanitize"),
                    help="where each tool's whole log is written")
    ap.add_argument("--launch", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_sanitize: CUDA is not available", file=sys.stderr)
        return 2
    if args.launch:
        launch()
        return 0
    cs.device_phase()
    _build.build(*cs.BUILD)
    os.makedirs(args.log_dir, exist_ok=True)
    tool_path, worst = sanitizer(), 0
    for tool in args.tools.split(","):
        cmd = [tool_path, "--tool", tool, "--print-limit", "200", sys.executable,
               os.path.abspath(__file__), "--launch"]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True, cwd=ROOT, start_new_session=True)
        try:
            log, _ = proc.communicate(timeout=args.timeout)
            rc = proc.returncode
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)  # the tool and the process it runs
            log, rc = proc.communicate()[0], "timeout"
        with open(os.path.join(args.log_dir, f"{tool}.log"), "w") as f:
            f.write(log)
        report(tool, rc, log)
        if "# sanitize: launched" not in log:
            print(f"#   {tool}: the launches did not complete under the tool")
            worst = 1
        elif rc != 0:
            worst = 1
    return worst


if __name__ == "__main__":
    sys.exit(main())
