"""Where the time of the port's fused_egcl kernel goes, on one CUDA card.

    python3 scripts/torch_egcl_breakdown.py

Builds csrc/fused_egcl.cu as it is and in variants that leave one part of
the work out (the source is edited in a temporary copy; the package has no
such switch), and times each at the dock path's shapes (DB5 1AVX, P = 16
poses, N = 448, K = 60, C = 256; chip_smoke.py's seeded inputs):

  full          the kernel as shipped;
  no_products   the wgmma instructions removed (gather, ring, epilogue);
  no_gather     every edge row written as zeros, nothing staged or read for
                it (ring, products, epilogue);
  neither       both removed (edge metadata, ring and epilogue only).

Prints the card's name and power limit, ptxas's resource lines for the
kernel as shipped (`-Xptxas -v`) and the count of tensor-core (HGMMA) and
bulk-copy (UBLKCP) instructions in its SASS (`cuobjdump -sass`), then one
line per variant and body with CUDA-event and profiler device times per
launch, for both precision modes (three passes, and the single-pass bf16
mode: `_bf16`).  Only the full variant computes the function; the others
are timings, not results.
"""
from __future__ import annotations

import ctypes
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
from dfmdock_tpu_torch.ops import fused_egcl as fe  # noqa: E402

PRODUCTS = ("        if (!SINGLE) {\n          wgmma(d, al, bh);\n          wgmma(d, ah, bl);\n"
            "        }\n        wgmma(d, ah, bh);\n")
GATHER = ("    if (m.valid[r]) {", "if (m.valid[r])\n            cp_async16(")


def no_gather(src: str) -> str:
    for line in GATHER:
        src = src.replace(line, line.replace("m.valid[r]", "false"))
    return src


def variants(src: str) -> dict[str, str]:
    if PRODUCTS not in src or any(line not in src for line in GATHER):
        raise RuntimeError("csrc/fused_egcl.cu no longer has the edited lines")
    no_products = src.replace(PRODUCTS, "")
    return {"full": src, "no_products": no_products, "no_gather": no_gather(src),
            "neither": no_gather(no_products)}


def build(texts: dict[str, str], out_dir: str) -> dict[str, str]:
    procs = {}
    for name, text in texts.items():
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(out_dir, f"{name}.so")
        verbose = ["-Xptxas", "-v"] if name == "full" else []
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *verbose, "-o", so, cu]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {name} variant:\n{log}")
        if name == "full":
            for line in log.splitlines():
                if "registers" in line or "spill" in line or "Compiling entry" in line:
                    print(f"# ptxas: {line.strip()}", flush=True)
        libs[name] = so
    return libs


def sass_counts(so: str) -> dict[str, int]:
    """HGMMA and UBLKCP instructions in the library's SASS."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", so], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass)) for op in ("HGMMA", "UBLKCP")}


def main():
    if not torch.cuda.is_available():
        print("torch_egcl_breakdown: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    cs.device_phase()
    src = (_build.CSRC / "fused_egcl.cu").read_text()
    _build.BUILD_DIR.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as out_dir:
        libs = build(variants(src), out_dir)
        print(f"# sass of the kernel as shipped: {sass_counts(libs['full'])}", flush=True)
        raw = load_npz_complex(cs.NPZ)
        batch, pos, idx, edge_mask = cs.edge_inputs(raw, cs.N_PAD, cs.P, 0, dev)
        ebin, egeo = cs.build_edge_table(idx, pos, batch["res_id"], batch["asym_id"],
                                         normalize=True)
        args, coord = cs.fused_inputs(idx, edge_mask, ebin, egeo, 256, 0, dev)
        print(f"# inputs: P={cs.P} N={cs.N_PAD} K={idx.shape[-1]} C=256, valid edges "
              f"{int((edge_mask > 0.5).sum())}/{edge_mask.numel()}", flush=True)
        for name, so in libs.items():
            fn = ctypes.CDLL(so).fused_egcl_launch
            fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            fe._lib = lambda fn=fn: fn
            bf16 = torch.bfloat16
            for body, call in (
                    ("fused_egcl", lambda: fe.fused_edge_layer(*args)),
                    ("fused_egcl_coord", lambda: fe.fused_edge_layer(*args, coord)),
                    ("fused_egcl_bf16", lambda: fe.fused_edge_layer(*args, dtype=bf16)),
                    ("fused_egcl_coord_bf16",
                     lambda: fe.fused_edge_layer(*args, coord, dtype=bf16))):
                print(f"# {name} {body}: {cs.time_ms(call):.4f} ms/launch (events), device "
                      f"{cs.device_ms(call):.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
