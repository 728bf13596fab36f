"""Build, load and launch the hand-written CUDA kernels of `csrc/`.

Every `csrc/*.cu` is compiled at first use with `nvcc` (one process per
source, all started together, then one link) into a single plain shared
library (no PyTorch headers: seconds to build instead of minutes) and
loaded through ctypes. The library is cached under `_build/` in this
package (listed in `.gitignore`), keyed by a hash of all the sources and
the flags, so an edited source rebuilds and an unchanged set loads at
once.

Nothing here runs at import: the CPU tests import every module of the
port, and the CPU has no `nvcc`. A missing `nvcc` or a failed build is
an error, never a switch to the plain versions.

`launch_counts` counts launches per kernel: a wrapper adds one where it
launches its kernel and nowhere else, so a run can show that its main
path went through the kernels. The server launches from its event loop
and from ingest worker threads at once, so counting takes a lock.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Optional

import torch

from morphik_core_tpu_torch import device as _device  # noqa: F401  (sets the TF32 flags)

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

launch_counts: Dict[str, int] = {"maxsim_q8": 0, "maxsim": 0, "window_attention": 0}

_counts_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def reset_launch_counts() -> None:
    with _counts_lock:
        for name in launch_counts:
            launch_counts[name] = 0


def count_launch(name: str) -> None:
    with _counts_lock:
        launch_counts[name] += 1


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): cannot build the CUDA kernels")


def build(verbose: bool = False) -> Path:
    """Compile every `csrc/*.cu` if no library of these sources and flags
    exists yet; returns the library path."""
    srcs = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in srcs:
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    lib = BUILD_DIR / f"libkernels_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    ptxas = ["-Xptxas", "-v"] if verbose else []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [f"{tmp}/{src.stem}.o" for src in srcs]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, *ptxas, "-c", "-o", obj, str(src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(srcs, objs)]
        outs = [proc.communicate()[0] for proc in procs]  # every nvcc ends before any raise
        for src, proc, out in zip(srcs, procs, outs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name} ({proc.returncode}):\n{out}")
            if verbose:
                print(f"{src.name}:\n{out}")
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", f"{tmp}/{lib.name}", *objs],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        os.replace(f"{tmp}/{lib.name}", lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.maxsim_init.argtypes = []
            lib.maxsim_init.restype = ci
            lib.maxsim_q8_launch.argtypes = [vp] * 8 + [ci] * 8 + [vp]
            lib.maxsim_q8_launch.restype = ci
            lib.maxsim_launch.argtypes = [vp, vp, ci, vp, vp, vp, vp] + [ci] * 8 + [vp]
            lib.maxsim_launch.restype = ci
            lib.window_attention_launch.argtypes = [vp] * 4 + [ci] * 5 + [vp]
            lib.window_attention_launch.restype = ci
            lib.window_attention_init.argtypes = []
            lib.window_attention_init.restype = ci
            _check(lib.maxsim_init(), "maxsim_init")  # shared-memory limits, once per load
            _check(lib.window_attention_init(), "window_attention_init")
            _lib = lib
    return _lib


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def launch_maxsim_q8(q8, qs, d8, ds, mask, idx, part, out, plan) -> None:
    """K1 on already-checked CUDA tensors (see ops/maxsim.py::maxsim_q8);
    `part` is the (C, n_splits, NQ) f32 scratch of `plan`."""
    n_rows, np_, dim = d8.shape
    rc = library().maxsim_q8_launch(
        _ptr(q8), _ptr(qs), _ptr(d8), _ptr(ds), _ptr(mask), _ptr(idx), _ptr(part), _ptr(out),
        out.shape[0], n_rows, np_, q8.shape[0], dim, plan.q_tile, plan.tok_per_split, plan.n_splits,
        ctypes.c_void_p(torch.cuda.current_stream(d8.device).cuda_stream),
    )
    _check(rc, "maxsim_q8")
    count_launch("maxsim_q8")


def launch_maxsim(q, docs, mask, idx, part, out, plan) -> None:
    """K2 on already-checked CUDA tensors (see ops/maxsim.py::maxsim)."""
    n_rows, np_, dim = docs.shape
    rc = library().maxsim_launch(
        _ptr(q), _ptr(docs), int(docs.dtype == torch.bfloat16), _ptr(mask), _ptr(idx), _ptr(part),
        _ptr(out), out.shape[0], n_rows, np_, q.shape[0], dim, plan.q_tile, plan.tok_per_split,
        plan.n_splits, ctypes.c_void_p(torch.cuda.current_stream(docs.device).cuda_stream),
    )
    _check(rc, "maxsim")
    count_launch("maxsim")


def launch_window_attention(q, k, v, out, window: int) -> None:
    """K3 on already-checked CUDA tensors (see ops/window_attention.py)."""
    t, heads, dim = q.shape
    rc = library().window_attention_launch(
        _ptr(q), _ptr(k), _ptr(v), _ptr(out), int(q.dtype == torch.bfloat16), t, heads, dim, window,
        ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream),
    )
    _check(rc, "window_attention")
    count_launch("window_attention")
