"""Where the time of the port's fused_egcl kernels goes, on one CUDA card.

    python3 scripts/torch_egcl_breakdown.py [--parent-source FILE] [--sass FILE]

Builds csrc/fused_egcl.cu as it is and in variants that leave one part of
the work out (the source is edited in a temporary copy; the package has no
such switch), and times each at the dock path's shapes (DB5 1AVX, P = 16
poses, N = 448, K = 60, C = 256; chip_smoke.py's seeded inputs), called as
the main path calls it (the weights' kernel-side form built once, B as
bf16 in the bf16 mode):

  full          the kernels as shipped;
  no_products   the wgmma instructions removed (gather, ring, epilogue);
  no_gather     no edge row gathered, staged or built: A is zero (ring,
                products, epilogue);
  neither       both removed;
  no_ring       the bf16 kernel's W ring copies nothing (its barriers
                still pass, the products read stale stages);
  clocks        the bf16 kernel with clock64() read at its phase
                boundaries (each warp's cycles per phase summed in shared
                memory and written over agg, which it then does not
                compute): where a launch's cycles go, per warp.

Prints the card's name and power limit, ptxas's resource lines for the
kernels as shipped (`-Xptxas -v`, and any ptxas warning) and the count of
tensor-core (HGMMA) and bulk-copy (UBLKCP) instructions in their SASS
(`cuobjdump -sass`), then one line per variant and body with CUDA-event
and profiler device times per launch (the call, and the kernel alone), for
both modes (three passes; the single-pass bf16 mode: `_bf16`).  Only the
full variant computes the function; the others are timings, not results.

--sass FILE writes the kernels' SASS there.  --parent-source FILE: also
build another fused_egcl.cu whose C interface is the one before the bf16
mode had its own kernel (one launcher,
`fused_egcl_launch(..., int single, stream)`, W hi-only for the bf16 mode
in slices of 16 rows, f32 B and tables), and time its two modes on the
same inputs, before and after this source's variants; print how far its
outputs lie from this source's (its float32 mode must give the same bits).
"""
from __future__ import annotations

import argparse
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

# the three-pass kernel's products and gather
PRODUCTS = "        wgmma(d, al, bh);\n        wgmma(d, ah, bl);\n        wgmma(d, ah, bh);\n"
GATHER = ("    if (m.valid[r]) {", "if (m.valid[r])\n            cp_async16(")
# the bf16 kernel's products, gather and ring; its phase clocks
PRODUCTS_BF16 = re.compile(r"      wgmma_ra\(d, [^;]*\);\n")
GATHER_BF16 = (
    ("      build(frag[s & 1], s, q, ai_s, wr_s, bst + (bseq + s) % BSTAGES * 2 * BSLOT, "
     "tab_s, off,\n            rad);", "      for (int z = 0; z < 8; ++z) frag[s & 1][z] = 0u;"),
    ("      if (boff[e] >= 0)\n        cp_async16(", "      if (false)\n        cp_async16("),
)
RING_BF16 = ("    expect_tx(&full[st], SLICE);\n", "    expect_tx(&full[st], 0);\n    return;\n")
CLOCK_PHASES = ("node start: metadata", "wait for B, stage the next", "build A",
                "wait for a W slice", "issue wgmma", "wgmma wait, release",
                "epilogue (agg)", "coord epilogue")
CLOCKS_BF16 = (
    ("  extern __shared__ __align__(128) uint8_t smem[];\n",
     "  extern __shared__ __align__(128) uint8_t smem[];\n"
     "  __shared__ unsigned long long clk_s[8][8];\n"
     "  if (threadIdx.x < 64) clk_s[threadIdx.x / 8][threadIdx.x % 8] = 0;\n"
     "  unsigned long long clk_mark = clock64();\n"
     "#define TICK(i) do { const unsigned long long now_ = clock64(); "
     "if ((threadIdx.x & 31) == 0) atomicAdd(&clk_s[threadIdx.x >> 5][i], now_ - clk_mark); "
     "clk_mark = now_; } while (0)\n"),
    ("    uint32_t frag[2][8];\n", "    TICK(0);\n    uint32_t frag[2][8];\n"),
    ("      build(frag[s & 1], s,", "      TICK(1);\n      build(frag[s & 1], s,"),
    ("            rad);\n      u = ring.acquire();\n",
     "            rad);\n      TICK(2);\n      u = ring.acquire();\n      TICK(3);\n"),
    ("      u = ring.acquire();\n      const uint8_t* w = ring.stage(u % STAGES);\n"
     "      fence_acc(d);\n      wgmma_fence();\n      wgmma_ra(d, m2g",
     "      TICK(6);\n      u = ring.acquire();\n      TICK(3);\n      const uint8_t* w = "
     "ring.stage(u % STAGES);\n      fence_acc(d);\n      wgmma_fence();\n      wgmma_ra(d, m2g"),
    ("      wgmma_commit();\n", "      wgmma_commit();\n      TICK(4);\n"),
    ("      if (s > 0) ring.release(u - 1, lane);\n",
     "      if (s > 0) ring.release(u - 1, lane);\n      TICK(5);\n"),
    ("    ring.release(u, lane);\n", "    ring.release(u, lane);\n    TICK(5);\n"),
    ("    if (!COORD) continue;\n", "    TICK(6);\n    if (!COORD) continue;\n"),
    ("tpart[8 + tid]) + tpart[12 + tid];\n  }\n", "tpart[8 + tid]) + tpart[12 + tid];\n"
     "    TICK(7);\n  }\n"),
    ("        *reinterpret_cast<float2*>(agg + row * C + c) = out;\n      }\n    }\n    TICK(6);",
     "        if (row < 0) *reinterpret_cast<float2*>(agg + row * C + c) = out;\n      }\n    }\n"
     "    TICK(6);"),
    ("    TICK(7);\n  }\n}\n",
     "    TICK(7);\n  }\n  __syncthreads();\n  if (threadIdx.x < 64)\n"
     "    reinterpret_cast<unsigned long long*>(agg)"
     "[blockIdx.x * 64 + threadIdx.x] = clk_s[threadIdx.x / 8][threadIdx.x % 8];\n}\n"),
)
BODIES = ("fused_egcl", "fused_egcl_coord", "fused_egcl_bf16", "fused_egcl_coord_bf16")
KERNEL_NAMES = {"fused_egcl": "fused_egcl_kernel<false>",
                "fused_egcl_coord": "fused_egcl_kernel<true>",
                "fused_egcl_bf16": "onepass::fused_egcl_bf16_kernel<false>",
                "fused_egcl_coord_bf16": "onepass::fused_egcl_bf16_kernel<true>"}
PARENT_NAMES = {"fused_egcl": "fused_egcl_kernel<false, false>",
                "fused_egcl_coord": "fused_egcl_kernel<true, false>",
                "fused_egcl_bf16": "fused_egcl_kernel<false, true>",
                "fused_egcl_coord_bf16": "fused_egcl_kernel<true, true>"}


def edit(src: str, old: str, new: str) -> str:
    if old not in src:
        raise RuntimeError(f"csrc/fused_egcl.cu no longer has the edited line {old!r}")
    return src.replace(old, new)


def no_products(src: str) -> str:
    if len(PRODUCTS_BF16.findall(src)) != 4:
        raise RuntimeError("csrc/fused_egcl.cu: expected four wgmma_ra calls")
    return PRODUCTS_BF16.sub("", edit(src, PRODUCTS, ""))


def no_gather(src: str) -> str:
    for line in GATHER:
        src = edit(src, line, line.replace("m.valid[r]", "false"))
    for old, new in GATHER_BF16:
        src = edit(src, old, new)
    return src


def clocks(src: str) -> str:
    head, mark, tail = src.partition("namespace onepass {")   # the bf16 kernel alone
    for old, new in CLOCKS_BF16:
        if tail.count(old) not in (1, 2):
            raise RuntimeError(f"csrc/fused_egcl.cu: the clock edit {old[:40]!r} does not fit")
        tail = tail.replace(old, new)
    return head + mark + tail


def variants(src: str) -> dict[str, str]:
    return {"full": src, "no_products": no_products(src), "no_gather": no_gather(src),
            "neither": no_gather(no_products(src)), "no_ring": edit(src, *RING_BF16),
            "clocks": clocks(src)}


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
                if any(w in line for w in ("registers", "spill", "Compiling entry", "arning",
                                           "wgmma", "Performance")):
                    print(f"# ptxas: {line.strip()}", flush=True)
        libs[name] = so
    return libs


def sass_counts(so: str, out: str | None = None) -> dict[str, int]:
    """HGMMA and UBLKCP instructions in the library's SASS (all of it
    written to `out`, where given)."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", so], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            f.write(sass)
    return {op: len(re.findall(rf"\b{op}\b", sass)) for op in ("HGMMA", "UBLKCP")}


def launchers(so: str):
    """This source's two launchers in the library, as fused_egcl._lib gives them."""
    lib = ctypes.CDLL(so)
    fns = {False: lib.fused_egcl_launch, True: lib.fused_egcl_bf16_launch}
    fns[False].argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fns[True].argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    for fn in fns.values():
        fn.restype = ctypes.c_int
    return fns


def parent_calls(so: str, args, coord):
    """{body: call} of the parent source's kernel on `args`, its weights
    laid out as its wrapper did (hi / lo slices of 16 rows, the hi piece
    alone for the bf16 mode), outside the timed call."""
    fn = ctypes.CDLL(so).fused_egcl_launch
    fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    idx, edge_mask, ebin, egeo, a, B, t_sp, t_p, w_r, w_l1, b_l1, w_att, b_att = args
    p, n, k, _ = ebin.shape
    c = a.shape[-1]
    dev = a.device

    def call(with_coord, single):
        w1, wc = (fe.prepare_weight(w)[:, :1].contiguous() if single else fe.prepare_weight(w)
                  for w in (w_l1, coord[0]))
        agg = torch.empty((p, n, c), device=dev)
        trans = torch.empty((p, n, 3), device=dev)
        ptr = lambda t: None if t is None else t.data_ptr()
        extra = (wc, coord[1], coord[2], trans) if with_coord else (None,) * 4

        def run():
            rc = _build.launch(fn, dev, idx.data_ptr(), edge_mask.data_ptr(), ebin.data_ptr(),
                               egeo.data_ptr(), a.data_ptr(), B.data_ptr(), t_sp.data_ptr(),
                               t_p.data_ptr(), w_r.data_ptr(), w1.data_ptr(), b_l1.data_ptr(),
                               w_att.data_ptr(), b_att.data_ptr(), *map(ptr, extra[:3]),
                               agg.data_ptr(), ptr(extra[3]), p, n, k, c, int(with_coord),
                               int(single))
            _build.check(rc, "parent fused_egcl")
            return (agg, trans) if with_coord else agg
        return run

    return {"fused_egcl": call(False, False), "fused_egcl_coord": call(True, False),
            "fused_egcl_bf16": call(False, True), "fused_egcl_coord_bf16": call(True, True)}


def phase_clocks(so, args16, prep, coord):
    """The clocks variant's per-warp cycles by phase, for both bf16 bodies:
    each phase's share of the warps' cycles and its mean per warp in µs at
    the clock the launch's own elapsed time implies."""
    fn = launchers(so)[True]
    idx, edge_mask, ebin, egeo, a, B, _, _, w_r, _, b_l1, w_att, b_att = args16
    p, n, k, _ = ebin.shape
    c, dev = a.shape[-1], a.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for body, with_coord in (("fused_egcl_bf16", False), ("fused_egcl_coord_bf16", True)):
        w = prep[torch.bfloat16, with_coord]
        out = torch.zeros((p, n, c), device=dev)
        trans = torch.empty((p, n, 3), device=dev)
        extra = ((w.wc.data_ptr(), coord[1].data_ptr(), coord[2].data_ptr(), trans.data_ptr())
                 if with_coord else (None,) * 4)

        def run():
            rc = _build.launch(fn, dev, idx.data_ptr(), edge_mask.data_ptr(), ebin.data_ptr(),
                               egeo.data_ptr(), a.data_ptr(), B.data_ptr(), w.tables.data_ptr(),
                               w_r.data_ptr(), w.w1.data_ptr(), b_l1.data_ptr(),
                               w_att.data_ptr(), b_att.data_ptr(), *extra[:3], out.data_ptr(),
                               extra[3], p, n, k, c, fe.TABLE_ROWS, int(with_coord))
            _build.check(rc, "fused_egcl clocks")

        run()
        out.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
        clk = out.view(-1).view(torch.int64)[: sms * 64].reshape(sms, 8, 8).double()
        warps = clk.sum(-1) > 0
        per = clk[warps].mean(0)
        ghz = float(per.sum()) / (ms * 1e6)
        print(f"# clocks {body}: {int(warps.sum())} warps, {ms:.4f} ms, {float(per.sum()):.0f} "
              f"cycles a warp (~{ghz:.2f} GHz): " + "; ".join(
                  f"{name} {float(v) / ghz / 1e6:.4f} ms ({100 * float(v / per.sum()):.1f}%)"
                  for name, v in zip(CLOCK_PHASES, per)), flush=True)


def report(tag, body, call, kernel_name):
    per_kernel = cs.device_ms(call, per_kernel=True)
    kernel = next((v for name, v in per_kernel.items() if name.endswith(kernel_name)),
                  float("nan"))
    print(f"# {tag} {body}: {cs.time_ms(call):.4f} ms/launch (events), device "
          f"{sum(per_kernel.values()) if per_kernel else float('nan'):.4f} ms, the kernel "
          f"alone {kernel:.4f} ms", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--parent-source", default=None, metavar="FILE")
    ap.add_argument("--sass", default=None, metavar="FILE",
                    help="write the SASS of the kernels as shipped here")
    args_ns = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_egcl_breakdown: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    cs.device_phase()
    texts = variants((_build.CSRC / "fused_egcl.cu").read_text())
    if args_ns.parent_source:
        with open(args_ns.parent_source) as f:
            texts["parent"] = f.read()
    _build.BUILD_DIR.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as out_dir:
        libs = build(texts, out_dir)
        counts = sass_counts(libs["full"], args_ns.sass)
        print(f"# sass of the kernels as shipped: {counts}", flush=True)
        raw = load_npz_complex(cs.NPZ)
        batch, pos, idx, edge_mask = cs.edge_inputs(raw, cs.N_PAD, cs.P, 0, dev)
        ebin, egeo = cs.build_edge_table(idx, pos, batch["res_id"], batch["asym_id"],
                                         normalize=True)
        args, coord = cs.fused_inputs(idx, edge_mask, ebin, egeo, 256, 0, dev)
        print(f"# inputs: P={cs.P} N={cs.N_PAD} K={idx.shape[-1]} C=256, valid edges "
              f"{int((edge_mask > 0.5).sum())}/{edge_mask.numel()}", flush=True)
        bf16 = torch.bfloat16
        args16 = (*args[:5], args[5].to(bf16), *args[6:])
        prep = {(dt, c0 is not None): fe.prepare_layer(*args[6:8], args[9], c0, dt)
                for dt in (None, bf16) for c0 in (None, coord[0])}
        calls = {
            "fused_egcl": lambda: fe.fused_edge_layer(*args, prepared=prep[None, False]),
            "fused_egcl_coord": lambda: fe.fused_edge_layer(*args, coord,
                                                            prepared=prep[None, True]),
            "fused_egcl_bf16": lambda: fe.fused_edge_layer(*args16, dtype=bf16,
                                                           prepared=prep[bf16, False]),
            "fused_egcl_coord_bf16": lambda: fe.fused_edge_layer(
                *args16, coord, dtype=bf16, prepared=prep[bf16, True])}
        parent = parent_calls(libs.pop("parent"), args, coord) if "parent" in libs else None
        if parent:
            for body in BODIES:
                report("parent (before)", body, parent[body], PARENT_NAMES[body])
        phase_clocks(libs.pop("clocks"), args16, prep, coord)
        for name, so in libs.items():
            fns = launchers(so)
            fe._lib = lambda single, fns=fns: fns[single]
            for body in BODIES:
                report(name, body, calls[body], KERNEL_NAMES[body])
            if name == "full":
                outs = {body: calls[body]() for body in BODIES}
        if parent:
            for body in BODIES:
                report("parent (after)", body, parent[body], PARENT_NAMES[body])
            for body in BODIES:
                mine, theirs = (cs._parts(o()) if callable(o) else cs._parts(o)
                                for o in (outs[body], parent[body]))
                for i, (x, y) in enumerate(zip(mine, theirs)):
                    diff = float((x - y).abs().max() / y.abs().max())
                    print(f"# {body} output {i}: this source against the parent's: "
                          f"bit-equal {torch.equal(x, y)}, max |diff| {diff:.3e} of the "
                          f"largest", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
