"""Build the CUDA kernels of `csrc/` at first use and load them with ctypes.

Each source is one `extern "C"` launcher compiled by plain nvcc into a shared
library (no PyTorch headers, so a build takes seconds).  Libraries land in
`dfmdock_tpu_torch/_build/` (git-ignored), named by a hash of the source and
the flags, so an edited source rebuilds and an unchanged one is reused.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
    "-shared", "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}_{digest}.so"


def build(*names: str) -> dict[str, float]:
    """Compile every named source that has no library yet, all nvcc
    processes at once; returns {name: seconds} for the ones compiled."""
    BUILD_DIR.mkdir(exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    seconds, failed = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()  # every nvcc is waited for, failed or not
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
        seconds[name] = time.perf_counter() - t0
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The launcher library of csrc/<name>.cu (built if missing)."""
    build(name)
    return ctypes.CDLL(str(library_path(name)))


def check(rc: int, name: str):
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def aligned(t):
    """t itself when its data starts on 16 bytes (the kernels' vector
    loads), else a copy."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def require(t, name: str, dtype, shape: tuple, device):
    """Validate one kernel argument before its pointer is passed on: a
    tensor on `device`, of `dtype` and `shape` (a tuple), contiguous.  One
    test of all five on the way through; the message only on failure."""
    if (isinstance(t, torch.Tensor) and t.dtype == dtype and t.shape == shape
            and t.is_contiguous() and t.device == device):
        return
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    raise ValueError(f"{name}: not contiguous")


def launch(fn, device, *args) -> int:
    """Call the launcher `fn` with `args` and the raw handle of `device`'s
    current stream, with `device` the current CUDA device (made current for
    the call alone when another is): the launcher's cudaError_t."""
    index = device.index
    if torch.cuda.current_device() == index:
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(index):
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))
