"""Build, load, launch and count the hand-written CUDA kernels.

The sources under ``csrc/`` have a plain C interface.  ``nvcc`` compiles
each ``.cu`` file to an object in parallel, links them into one shared
library in the git-ignored ``build/`` directory (named by a hash of the
sources and flags, renamed into place when complete), and ``ctypes`` binds
it.  No PyTorch headers, no ``torch.utils.cpp_extension``, no ninja.

Nothing is built at import: the first CUDA launch (or ``chip_smoke.py``)
calls :func:`library`.  Each wrapper adds one to ``LAUNCHES[name]`` where it
launches its kernel, and nowhere else.

Every wrapper launches through :func:`launch`, which switches the current
device only when the operands lie on another, with its field's constants
made once (:func:`field_consts`).  The field products (K2, K3) run on every
product of a proof, so their host work per call matters: they also reach
broadcast operands as element strides (:func:`expanded_strides`,
:func:`fold`) instead of copies.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading

import torch

from zkmember_tpu_torch import _build

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
SOURCES = ("mont_mul.cu", "mont_mul_bm.cu", "select_reduce.cu", "msm_finish.cu")
HEADERS = ("field.cuh", "point.cuh")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES = {"mont_mul": 0, "select_reduce_fp": 0, "select_reduce_fp2": 0, "mont_mul_bm": 0,
            "msm_finish_fp": 0, "msm_finish_fp2": 0, "select_reduce_fp48": 0,
            "msm_finish_fp48": 0}

_lock = threading.Lock()
_lib = None
_FIELD_CONSTS: dict = {}
BUILD_LOG = ""  # compiler output of the build this process ran (ptxas -v)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return path


def _build_library(path: str) -> str:
    """Compile every source in parallel, link one .so, rename it to `path`."""
    nvcc = nvcc_path()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    log = []
    with tempfile.TemporaryDirectory(dir=os.path.dirname(path)) as tmpdir:
        objs, procs = [], []
        for src in SOURCES:
            obj = os.path.join(tmpdir, src.replace(".cu", ".o"))
            cmd = [nvcc, *FLAGS, "-c", os.path.join(CSRC, src), "-o", obj]
            procs.append((src, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
            objs.append(obj)
        failed = []
        for src, proc in procs:
            out, _ = proc.communicate(timeout=900)
            log.append(f"== {src}\n{out}")
            if proc.returncode != 0:
                failed.append(src)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
        tmp = _build.tmp_path(path)
        log.append(_build.run_build(
            [nvcc, *ARCH, "-shared", "-o", tmp, *objs], tmp, path, timeout=300))
    return "\n".join(log)


def library():
    """The loaded kernel library, built on first use."""
    global _lib, BUILD_LOG
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        sources = [os.path.join(CSRC, f) for f in SOURCES + HEADERS]
        path = _build.lib_path("zk_kernels", sources, FLAGS)
        if not os.path.exists(path):
            BUILD_LOG = _build_library(path)
        lib = ctypes.CDLL(path)
        vp, ll, i32, u32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_uint32
        u32p = ctypes.POINTER(ctypes.c_uint32)
        lib.zk_mont_mul.argtypes = [i32, vp, vp, vp, ll, ll, ll, ll, ll, ll, ll, ll, u32p, u32,
                                    vp]
        lib.zk_mont_mul.restype = i32
        lib.zk_mont_mul_bm.argtypes = [i32, vp, vp, vp, ll, ll, ll, ll, ll, ll, u32p, u32, vp]
        lib.zk_mont_mul_bm.restype = i32
        lib.zk_select_reduce.argtypes = [
            i32, i32, vp, vp, ctypes.POINTER(vp), i32, i32, i32, ll, i32, u32p, u32, i32, i32,
            vp,
        ]
        lib.zk_select_reduce.restype = i32
        vpp = ctypes.POINTER(vp)
        lib.zk_msm_finish.argtypes = [
            i32, i32, vpp, vpp, vp, vp, vp, vp, i32, i32, ll, i32, i32, u32p, u32, i32, i32, i32,
            vp,
        ]
        lib.zk_msm_finish.restype = i32
        _lib = lib
        return _lib


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {rc}")


def field_consts(spec):
    """p's 32-bit words as a ctypes array and np0 = -p^-1 mod 2^32: a field's
    launch constants, made once per field."""
    c = _FIELD_CONSTS.get(spec.p)
    if c is None:
        words = [int(w) for w in spec.p_words]
        c = _FIELD_CONSTS[spec.p] = ((ctypes.c_uint32 * len(words))(*words), spec.np32)
    return c


def launch(fn, device, *args) -> int:
    """fn(*args, stream) with the current stream of CUDA `device`; the current
    device is switched (and restored) only when it is another one."""
    if device.index == torch.cuda.current_device():
        return fn(*args, torch.cuda.current_stream(device).cuda_stream)
    with torch.cuda.device(device):
        return fn(*args, torch.cuda.current_stream(device).cuda_stream)


# -- launch geometry: pure functions of shapes and strides (tested on the CPU) --


def broadcast_shape(x: tuple, y: tuple) -> tuple:
    """The broadcast of two shapes (numpy's rule); equal shapes return at once."""
    if x == y:
        return tuple(x)
    nd = max(len(x), len(y))
    x = (1,) * (nd - len(x)) + tuple(x)
    y = (1,) * (nd - len(y)) + tuple(y)
    out = []
    for p, q in zip(x, y):
        if p != q and p != 1 and q != 1:
            raise ValueError(f"shapes {x} and {y} do not broadcast")
        out.append(q if p == 1 else p)
    return tuple(out)


def expanded_strides(shape: tuple, x_shape: tuple, x_strides: tuple) -> tuple:
    """Element strides of a view of shape `x_shape` expanded to `shape`: 0 on
    every axis it is broadcast along (and on any axis of size 1)."""
    pad = len(shape) - len(x_shape)
    return (0,) * pad + tuple(0 if size == 1 else st for size, st in zip(x_shape, x_strides))


def contiguous_strides(shape: tuple) -> tuple:
    """Element strides of a contiguous (row-major) array of `shape`."""
    out, step = [], 1
    for size in reversed(shape):
        out.append(step)
        step *= size
    return tuple(reversed(out))


def fold(sizes: tuple, strides: tuple):
    """The one element stride that walks the axes `sizes` (row-major, as if
    flattened) of a view with `strides`, or None where no single stride does."""
    step, span = 0, 0
    for size, st in zip(reversed(sizes), reversed(strides)):
        if size == 1:
            continue
        if span == 0:
            step, span = st, size
        elif st != step * span:
            return None
        else:
            span *= size
    return step
