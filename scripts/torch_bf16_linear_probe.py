"""The two forms of a bf16 product with a float32 result on a CUDA card.

    python3 scripts/torch_bf16_linear_probe.py [--reps 20]

`models/modules.linear(x, W, dtype=bfloat16)` rounds x and W to bf16 and
multiplies the rounded values in a float32 GEMM (the cast form).  The other
form is the bf16 GEMM with a float32 output, `torch.mm(a, b,
out_dtype=torch.float32)` (aten::mm.dtype).  At the shapes of a training
step at crop 448 (the EGCL edge MLP over 448 x 60 edges, the node
embedding, the energy head's halves) this prints, for each shape:
- whether the out_dtype form runs forward, backward and a second-order
  backward (the mlsb loss differentiates dedx again);
- its forward and its gradients with respect to x and W against the cast
  form's: the largest difference, in units of the largest value, and
  whether every gradient element is a bf16 value (the rounding of JAX's
  transpose of the cast, which the cast form reproduces);
- both forms against the float64 product of the rounded values;
- whether `torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction`
  changes either form's forward (bit for bit, off against on);
- the time of one forward and backward of each form (CUDA events, `--reps`
  back-to-back calls, after a warm-up).
Then one JSON line with the same numbers, the card's name and power limit.
Needs a card; torch only.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from dfmdock_tpu_torch.models.modules import linear  # noqa: E402

BF16 = torch.bfloat16
SHAPES = {  # name: (rows, in, out) of one product in a training step at crop 448
    "edge_mlp": (448 * 60, 256, 256),
    "single_embed": (448, 1301, 256),
    "energy_half": (448, 256, 256),
}


def out_dtype_form(x, w):
    """x W^T as one bf16 GEMM with a float32 output."""
    return torch.mm(x.to(BF16), w.to(BF16).t(), out_dtype=torch.float32)


def cast_form(x, w):
    return linear(x, w, dtype=BF16)


def run(form, x, w, g):
    """(y, dy/dx . g, dy/dW . g) of one form, the gradients by autograd."""
    xr = x.clone().requires_grad_(True)
    wr = w.clone().requires_grad_(True)
    y = form(xr, wr)
    gx, gw = torch.autograd.grad(y, (xr, wr), g)
    return y.detach(), gx, gw


def second_order(form, x, w, g):
    """The gradient of sum(dy/dx . g * x) with respect to W: a backward
    through the first backward."""
    xr = x.clone().requires_grad_(True)
    wr = w.clone().requires_grad_(True)
    (gx,) = torch.autograd.grad(form(xr, wr), xr, g, create_graph=True)
    (gw2,) = torch.autograd.grad((gx * x).sum(), wr)
    return gw2


def rel(a, b):
    return float((a.double() - b.double()).abs().max() / b.double().abs().max().clamp(min=1e-30))


def is_bf16(t):
    return bool(torch.equal(t.to(BF16).float(), t.float()))


def attempt(fn):
    """fn() or the text of the error it raised."""
    try:
        return fn(), None
    except (RuntimeError, NotImplementedError) as e:
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"


def time_ms(fn, reps):
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def probe(name, m, k, n, reps):
    gen = torch.Generator().manual_seed(sorted(SHAPES).index(name))
    x = torch.randn(m, k, generator=gen).cuda()
    w = (torch.randn(n, k, generator=gen) * 0.05).cuda()
    g = torch.randn(m, n, generator=gen).cuda()
    out = {"shape": [m, k, n]}
    y_c, gx_c, gw_c = run(cast_form, x, w, g)
    exact = x.to(BF16).double() @ w.to(BF16).double().t()
    out["cast"] = {"fwd_rel_to_f64": rel(y_c, exact), "gx_bf16": is_bf16(gx_c),
                   "gw_bf16": is_bf16(gw_c)}
    res, err = attempt(lambda: out_dtype_form(x, w))
    out["out_dtype_forward"] = err or "ok"
    if res is not None:
        out["out_dtype"] = {"fwd_rel_to_cast": rel(res, y_c),
                            "fwd_bit_equal_cast": bool(torch.equal(res, y_c)),
                            "fwd_rel_to_f64": rel(res, exact)}
        res, err = attempt(lambda: run(out_dtype_form, x, w, g))
        out["out_dtype_backward"] = err or "ok"
        if res is not None:
            _, gx_o, gw_o = res
            out["out_dtype"].update(
                gx_dtype=str(gx_o.dtype), gx_bf16=is_bf16(gx_o), gw_bf16=is_bf16(gw_o),
                gx_rel_to_cast=rel(gx_o, gx_c), gw_rel_to_cast=rel(gw_o, gw_c),
                gx_share_unequal=float((gx_o != gx_c).double().mean()),
                gw_share_unequal=float((gw_o != gw_c).double().mean()))
            res, err = attempt(lambda: second_order(out_dtype_form, x, w, g))
            out["out_dtype_second_order"] = err or "ok"
            if res is not None:
                out["out_dtype"]["second_order_rel_to_cast"] = rel(
                    res, second_order(cast_form, x, w, g))
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    try:
        forms = {"cast": cast_form}
        if "out_dtype" in out:
            forms["out_dtype"] = out_dtype_form
        for fname, form in forms.items():
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
            on = form(x, w)
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
            off = form(x, w)
            out[f"{fname}_reduced_precision_flag_changes_result"] = not torch.equal(on, off)
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = flag
    out["cast_fwd_bwd_ms"] = time_ms(lambda: run(cast_form, x, w, g), reps)
    if out.get("out_dtype_backward") == "ok":
        out["out_dtype_fwd_bwd_ms"] = time_ms(lambda: run(out_dtype_form, x, w, g), reps)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"# card: {card.strip()}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"allow_bf16_reduced_precision_reduction default "
          f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}")
    result = {"card": card.strip(), "torch": torch.__version__, "shapes": {}}
    for name, (m, k, n) in SHAPES.items():
        result["shapes"][name] = r = probe(name, m, k, n, args.reps)
        print(f"# {name}: {json.dumps(r)}", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
