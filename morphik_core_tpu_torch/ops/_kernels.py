"""Build, load and launch the hand-written CUDA kernels of `csrc/`.

Every `csrc/*.cu` (with the headers `csrc/*.cuh`) is compiled at first use with `nvcc` (one process per
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

A ctypes launch goes to the device that is current, which PyTorch's
device guards do not set for it, and the kernels' shared-memory limits
(`maxsim_init`, `window_attention_init`) hold only for the device that
was current when they were raised. So every launch makes its tensors'
device current (`_on`), and raises the limits there before its first
launch on that device: a mesh of several cards launches on each.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Iterator, Optional, Set

import torch

from morphik_core_tpu_torch import device as _device  # noqa: F401  (sets the TF32 flags)

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

launch_counts: Dict[str, int] = {"maxsim_q8": 0, "maxsim": 0, "window_attention": 0, "binary_maxsim": 0,
                                 "j2k_t1": 0, "j2k_ht": 0}

_counts_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
_ready_devices: Set[int] = set()  # card indices whose shared-memory limits are raised
_ht_tables_on: Set[int] = set()  # card indices whose constant memory holds K6's VLC tables


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
    for src in sorted(CSRC.glob("*.cu*")):   # the sources and the headers they share
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
            lib.window_attention_occupancy.argtypes = [ci] * 3 + [ctypes.POINTER(ci)] * 2
            lib.window_attention_occupancy.restype = ci
            lib.binary_maxsim_launch.argtypes = [vp] * 4 + [ci] * 5 + [vp]
            lib.binary_maxsim_launch.restype = ci
            lib.binary_maxsim_plan.argtypes = [ci, ctypes.POINTER(ci), ctypes.POINTER(ci)]
            lib.binary_maxsim_plan.restype = ci
            lib.j2k_t1_launch.argtypes = [vp] * 5 + [ci] * 4 + [vp]
            lib.j2k_t1_launch.restype = ci
            lib.j2k_t1_occupancy.argtypes = [ci] * 3 + [ctypes.POINTER(ci)] * 3
            lib.j2k_t1_occupancy.restype = ci
            lib.j2k_ht_init.argtypes = [vp]
            lib.j2k_ht_init.restype = ci
            lib.j2k_ht_launch.argtypes = [vp] * 5 + [ci] * 4 + [vp]
            lib.j2k_ht_launch.restype = ci
            lib.j2k_ht_occupancy.argtypes = [ci] * 3 + [ctypes.POINTER(ci)] * 3
            lib.j2k_ht_occupancy.restype = ci
            _lib = lib
    return _lib


@contextlib.contextmanager
def _on(device: torch.device) -> Iterator[ctypes.CDLL]:
    """The library, with `device` current and the kernels' shared-memory
    limits raised there (once a card)."""
    lib = library()
    with torch.cuda.device(device):
        if device.index not in _ready_devices:
            with _lib_lock:
                if device.index not in _ready_devices:
                    _check(lib.maxsim_init(), "maxsim_init")
                    _check(lib.window_attention_init(), "window_attention_init")
                    _ready_devices.add(device.index)
        yield lib


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def launch_maxsim_q8(q8, qs, d8, ds, mask, idx, part, out, plan) -> None:
    """K1 on already-checked CUDA tensors (see ops/maxsim.py::maxsim_q8);
    `part` is the (C, n_splits, NQ) f32 scratch of `plan`."""
    n_rows, np_, dim = d8.shape
    with _on(d8.device) as lib:
        rc = lib.maxsim_q8_launch(
            _ptr(q8), _ptr(qs), _ptr(d8), _ptr(ds), _ptr(mask), _ptr(idx), _ptr(part), _ptr(out),
            out.shape[0], n_rows, np_, q8.shape[0], dim, plan.q_tile, plan.tok_per_split, plan.n_splits,
            ctypes.c_void_p(torch.cuda.current_stream(d8.device).cuda_stream),
        )
    _check(rc, "maxsim_q8")
    count_launch("maxsim_q8")


def launch_maxsim(q, docs, mask, idx, part, out, plan) -> None:
    """K2 on already-checked CUDA tensors (see ops/maxsim.py::maxsim)."""
    n_rows, np_, dim = docs.shape
    with _on(docs.device) as lib:
        rc = lib.maxsim_launch(
            _ptr(q), _ptr(docs), int(docs.dtype == torch.bfloat16), _ptr(mask), _ptr(idx), _ptr(part),
            _ptr(out), out.shape[0], n_rows, np_, q.shape[0], dim, plan.q_tile, plan.tok_per_split,
            plan.n_splits, ctypes.c_void_p(torch.cuda.current_stream(docs.device).cuda_stream),
        )
    _check(rc, "maxsim")
    count_launch("maxsim")


def launch_window_attention(q, k, v, out, window: int) -> None:
    """K3 on already-checked CUDA tensors (see ops/window_attention.py):
    bf16 goes to `window_attention_mma_kernel`, f32 to the 3xTF32
    `window_attention_tf32_kernel`."""
    t, heads, dim = q.shape
    with _on(q.device) as lib:
        rc = lib.window_attention_launch(
            _ptr(q), _ptr(k), _ptr(v), _ptr(out), int(q.dtype == torch.bfloat16), t, heads, dim, window,
            ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream),
        )
    _check(rc, "window_attention")
    count_launch("window_attention")


def window_attention_occupancy(dtype: torch.dtype, dim: int, window: int) -> Dict[str, int]:
    """The blocks of 128 threads that the K3 kernel of this dtype and shape
    keeps resident on one SM, and its registers a thread (for reports)."""
    blocks, regs = ctypes.c_int(), ctypes.c_int()
    with _on(torch.device("cuda", torch.cuda.current_device())) as lib:
        rc = lib.window_attention_occupancy(int(dtype == torch.bfloat16), dim, window, ctypes.byref(blocks),
                                            ctypes.byref(regs))
    _check(rc, "window_attention_occupancy")
    return {"blocks_per_sm": blocks.value, "warps_per_sm": 4 * blocks.value, "registers_per_thread": regs.value}


def launch_binary_maxsim(q, docs, ntok, out, dim: int) -> None:
    """K4 on already-checked CUDA tensors (see ops/binary.py::binary_maxsim)."""
    n_rows, nd, nb = docs.shape
    with _on(docs.device) as lib:
        rc = lib.binary_maxsim_launch(
            _ptr(q), _ptr(docs), _ptr(ntok), _ptr(out), n_rows, nd, nb, q.shape[0], dim,
            ctypes.c_void_p(torch.cuda.current_stream(docs.device).cuda_stream),
        )
    _check(rc, "binary_maxsim")
    count_launch("binary_maxsim")


def binary_maxsim_plan(nq: int) -> Dict[str, int]:
    """K4's block shape for nq query tokens (for reports): query tokens
    a thread holds and threads a block."""
    qpt, threads = ctypes.c_int(), ctypes.c_int()
    _check(library().binary_maxsim_plan(nq, ctypes.byref(qpt), ctypes.byref(threads)), "binary_maxsim_plan")
    return {"query_tokens_per_thread": qpt.value, "threads_per_block": threads.value}


def launch_j2k_t1(data, segs, desc, out, next_block, nblocks: int, buffers) -> None:
    """K5 on already-packed CUDA tensors (see utils/jpeg2000_t1.py::
    j2k_t1_decode): every code block of one image, a warp a block;
    `next_block` is one int32 of scratch, `buffers` each warp's shared
    segment, coefficient and flag capacities (`k5_buffers`)."""
    seg_cap, dat_cap, flags_cap = buffers
    with _on(out.device) as lib:
        rc = lib.j2k_t1_launch(_ptr(data), _ptr(segs), _ptr(desc), _ptr(out), _ptr(next_block), nblocks, seg_cap,
                               dat_cap, flags_cap, ctypes.c_void_p(torch.cuda.current_stream(out.device).cuda_stream))
    _check(rc, "j2k_t1")
    count_launch("j2k_t1")


def launch_j2k_ht(data, desc, out, next_block, errors, nblocks: int, buffers) -> None:
    """K6 on already-packed CUDA tensors (see utils/jpeg2000_ht.py::
    j2k_ht_decode): every HT code block of one image, a warp a block, each
    block's error code (0: decoded) into `errors`; `next_block` is one
    int32 of scratch, `buffers` each warp's shared segment, sample and
    column capacities (`k6_buffers`)."""
    seg_cap, dat_cap, w_cap = buffers
    with _on(out.device) as lib:
        _ht_tables(lib, out.device)
        rc = lib.j2k_ht_launch(_ptr(data), _ptr(desc), _ptr(out), _ptr(next_block), _ptr(errors), nblocks, seg_cap,
                               dat_cap, w_cap, ctypes.c_void_p(torch.cuda.current_stream(out.device).cuda_stream))
    _check(rc, "j2k_ht")
    count_launch("j2k_ht")


def _ht_tables(lib, device: torch.device) -> None:
    """K6's VLC tables into this card's constant memory, once."""
    if device.index not in _ht_tables_on:
        with _lib_lock:
            if device.index not in _ht_tables_on:
                from morphik_core_tpu_torch.utils.jpeg2000_ht import VLC_TABLES

                _check(lib.j2k_ht_init(ctypes.c_char_p(VLC_TABLES.astype("<u2").tobytes())), "j2k_ht_init")
                _ht_tables_on.add(device.index)


def j2k_ht_occupancy(buffers) -> Dict[str, int]:
    """K6's geometry at these shared buffers (`k6_buffers`), for reports:
    warps a thread block, shared bytes a warp, resident warps a
    multiprocessor, registers a thread."""
    smem, warps, regs = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    with _on(torch.device("cuda", torch.cuda.current_device())) as lib:
        rc = lib.j2k_ht_occupancy(*buffers, ctypes.byref(smem), ctypes.byref(warps), ctypes.byref(regs))
    _check(rc, "j2k_ht_occupancy")
    return {"warps_per_block": 1, "shared_bytes_per_block": smem.value, "warps_per_sm": warps.value,
            "registers_per_thread": regs.value}


def j2k_t1_occupancy(buffers) -> Dict[str, int]:
    """K5's geometry at these shared buffers (`k5_buffers`), for reports:
    warps a thread block, shared bytes a warp, resident warps a
    multiprocessor, registers a thread."""
    smem, warps, regs = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    with _on(torch.device("cuda", torch.cuda.current_device())) as lib:
        rc = lib.j2k_t1_occupancy(*buffers, ctypes.byref(smem), ctypes.byref(warps), ctypes.byref(regs))
    _check(rc, "j2k_t1_occupancy")
    return {"warps_per_block": 1, "shared_bytes_per_block": smem.value, "warps_per_sm": warps.value,
            "registers_per_thread": regs.value}
