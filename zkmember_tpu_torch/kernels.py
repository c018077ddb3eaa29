"""Build, load and count the hand-written CUDA kernels.

The sources under ``csrc/`` have a plain C interface.  ``nvcc`` compiles
each ``.cu`` file to an object in parallel, links them into one shared
library in the git-ignored ``build/`` directory (named by a hash of the
sources and flags, renamed into place when complete), and ``ctypes`` binds
it.  No PyTorch headers, no ``torch.utils.cpp_extension``, no ninja.

Nothing is built at import: the first CUDA launch (or ``chip_smoke.py``)
calls :func:`library`.  Each wrapper adds one to ``LAUNCHES[name]`` where it
launches its kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading

from zkmember_tpu_torch import _build

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
SOURCES = ("mont_mul.cu", "mont_mul_bm.cu", "select_reduce.cu", "msm_finish.cu")
HEADERS = ("field.cuh", "point.cuh")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES = {"mont_mul": 0, "select_reduce_fp": 0, "select_reduce_fp2": 0, "mont_mul_bm": 0,
            "msm_finish_fp": 0, "msm_finish_fp2": 0}

_lock = threading.Lock()
_lib = None
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
        lib.zk_mont_mul.argtypes = [i32, vp, vp, vp, ll, ll, u32p, u32, vp]
        lib.zk_mont_mul.restype = i32
        lib.zk_mont_mul_bm.argtypes = [i32, vp, vp, vp, ll, u32p, u32, vp]
        lib.zk_mont_mul_bm.restype = i32
        lib.zk_select_reduce.argtypes = [
            i32, i32, vp, vp, ctypes.POINTER(vp), i32, i32, ll, i32, u32p, u32, i32, i32, vp,
        ]
        lib.zk_select_reduce.restype = i32
        vpp = ctypes.POINTER(vp)
        lib.zk_msm_finish.argtypes = [
            i32, i32, vpp, vpp, vpp, vpp, i32, i32, ll, i32, u32p, u32, u32p, i32, i32, vp,
        ]
        lib.zk_msm_finish.restype = i32
        _lib = lib
        return _lib


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {rc}")
