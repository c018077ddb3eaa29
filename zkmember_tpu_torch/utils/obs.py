"""Observability: phase timers, the ZKMEMBER_TRACE output, and the work
model against the H100's peaks (counterpart of zkmember_tpu.utils.obs).

One ``PhaseClock`` serves setup and both provers: each ``mark(name)`` adds
the host seconds since the previous mark to ``times[name]`` and, when the
caller traces, records them in a ``Profiler`` that emits one line per
phase.  The card is synchronized at every mark, so each phase holds its
own device work; with neither (what a caller gets unless it asks for
phase times or sets ZKMEMBER_TRACE) a mark is a no-op and adds no
synchronization.

The work model has two units that never mix.  ``mont_mul_work`` and
``straus_msm_work`` are the reference's: products of 16-bit limbs
(2.5 n^2 a Montgomery product), kept equal to it so that both packages'
counts compare.  The card's model counts IMADs, the 32-bit multiply-adds
the CUDA kernels issue (4 N^2 + N a product of N = n/2 words), for K1 and
the MSM finish from their shapes, against ``IMAD_PER_S`` and
``HBM_BYTES_PER_S``.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field

import torch


@dataclass
class PhaseRecord:
    name: str
    seconds: float
    meta: dict = field(default_factory=dict)


class Profiler:
    """Collects named phase timings; nestable via context manager.  emit:
    a callable that takes each phase's JSON line (None: record only)."""

    def __init__(self, emit=None):
        self.records: list[PhaseRecord] = []
        self.emit = emit

    @contextlib.contextmanager
    def phase(self, name: str, **meta):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, time.perf_counter() - t0, **meta)

    def record(self, name: str, seconds: float, **meta) -> None:
        rec = PhaseRecord(name, seconds, meta)
        self.records.append(rec)
        if self.emit:
            self.emit(json.dumps({"phase": rec.name, "s": round(rec.seconds, 4), **meta}))

    def summary(self) -> dict:
        out: dict = {}
        for r in self.records:
            out[r.name] = out.get(r.name, 0.0) + r.seconds
        return out

    def dump(self, stream=None):
        stream = sys.stderr if stream is None else stream
        for name, secs in sorted(self.summary().items(), key=lambda kv: -kv[1]):
            print(f"  {name:<28} {secs:8.3f}s", file=stream)


def stderr_line(s: str) -> None:
    """Print one trace line, '# ' + s, to the current sys.stderr."""
    print(f"# {s}", file=sys.stderr, flush=True)


def trace_profiler() -> Profiler | None:
    """A Profiler that emits to stderr when ZKMEMBER_TRACE is set (read at
    each call), else None."""
    return Profiler(emit=stderr_line) if os.environ.get("ZKMEMBER_TRACE") else None


class PhaseClock:
    def __init__(self, times: dict | None, device=None, profiler: Profiler | None = None):
        self.times = times
        self.profiler = profiler
        self.device = torch.device(device) if device is not None else None
        self.t = time.perf_counter()

    def __call__(self, name: str) -> None:
        if self.times is None and self.profiler is None:
            return
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        dt = now - self.t
        if self.times is not None:
            self.times[name] = self.times.get(name, 0.0) + dt
        if self.profiler is not None:
            self.profiler.record(name, dt)
        self.t = now


# ---------------------------------------------------------------------------
# the reference's work model: 16-bit limb products, equal to
# zkmember_tpu.utils.obs for every argument
# ---------------------------------------------------------------------------


def mont_mul_work(n_limbs: int) -> int:
    """u32 multiplies per Montgomery multiplication: full 2n-column pass
    plus two constant passes (~n^2/2 + n^2) => ~2.5 n^2."""
    return (5 * n_limbs * n_limbs) // 2


def straus_msm_work(
    num_lanes: int,
    n_limbs: int,
    nbits: int = 255,
    window_bits: int = 4,
    fp2: bool = False,
    tail: int = 256,
) -> int:
    """u32 multiplies for one Straus MSM as the reference counts it:
    adds = B*(2^c - 2) table + W*(B + tail/2*log2(tail) - tail) window
    reductions; each complete add costs ~14 base-field muls, tripled for
    Fp2 coordinates.  (The table term is a per-call build, which a key
    that keeps its tables never runs.)"""
    W = (nbits + window_bits - 1) // window_bits
    t = min(tail, num_lanes)
    reduce_adds = num_lanes - t + (t // 2) * max(1, int(math.log2(t)))
    adds = num_lanes * ((1 << window_bits) - 2) + W * reduce_adds
    muls_per_add = 14 * (3 if fp2 else 1)
    return adds * muls_per_add * mont_mul_work(n_limbs)


# ---------------------------------------------------------------------------
# the card's model: IMADs and bytes of the port's kernels
# ---------------------------------------------------------------------------

# H100 SXM published peaks (NVIDIA's datasheet): 3.35 TB/s of HBM and
# 67 TFLOP/s fp32 outside the tensor cores = 2 flops per FMA on 128 lanes per
# SM; the integer multiply-add pipe has half the lanes: 16.75e12 IMAD/s.  A
# 32x32->64 product takes two IMADs (low and high word).  Bounds count the
# multiplies only, so they are lower bounds.
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 67e12 / 4
# operands of a field-product timing that fit the 50 MB L2 are read from L2
# on repeated calls: its "bytes" bound is then no lower bound
L2_BYTES = 50 * 2**20

ADD_PRODUCTS = 12  # base-field products of one complete a = 0 addition
DOUBLE_PRODUCTS = 8  # and of one a = 0 doubling
TABLE = 16  # Straus table entries [0..15] P (4-bit windows)


def mont_mul_imads(n_limbs: int) -> int:
    """IMADs of one CIOS Montgomery product of N = n/2 words: 2 N^2 full
    32x32->64 products (two IMADs each) and N low-word m products."""
    words = n_limbs // 2
    return 4 * words * words + words


# The highest product rate chip_smoke.py has measured for K2 or K3 alone:
# K2 on (6, 24, 16,384) operands (98,304 BLS12-381 Fq products, a wave of
# the KZG route past its table budget) in 0.0095 ms of kernel time, about
# 6.08e12 IMAD/s (H100 80GB HBM3, 700.00 W; PERF.md section 6 names the run).
KERNEL_PEAK_IMAD_PER_S = 6 * 16_384 * mont_mul_imads(24) / 0.0095e-3


def _point(n_limbs: int, fp2: bool) -> tuple[int, int]:
    """(bytes of one projective point, products of one complete addition)."""
    c = 2 if fp2 else 1
    return 3 * c * n_limbs * 4, ADD_PRODUCTS * (3 if fp2 else 1)


def add_imads(n_limbs: int, fp2: bool, adds: int) -> int:
    """IMADs of `adds` complete additions (an Fp2 product is three base ones)."""
    return adds * _point(n_limbs, fp2)[1] * mont_mul_imads(n_limbs)


def select_reduce_work(n_limbs: int, fp2: bool, W: int, P: int, R: int, B: int,
                       NT: int) -> tuple[int, int]:
    """(bytes, IMADs) of K1 over digits (W, P, R, B) against a table of R rows
    of B lanes, each tile of B / NT lanes reduced to one of NT output lanes:
    the table, the digits and the window sums moved once; B - NT additions
    a window and row."""
    pb, _ = _point(n_limbs, fp2)
    rows = P * R
    nbytes = TABLE * R * B * pb + W * rows * B * 4 + W * rows * NT * pb
    return nbytes, add_imads(n_limbs, fp2, W * rows * (B - NT))


def finish_work(n_limbs: int, fp2: bool, W: int, rows: int, NT: int) -> tuple[int, int]:
    """(bytes, IMADs) of the MSM finish over window sums (W, rows, n, NT): the
    tail's NT - 1 additions a window and row, and each row's Horner join,
    4 (W - 1) doublings and W - 1 additions."""
    pb, prods = _point(n_limbs, fp2)
    dbl = DOUBLE_PRODUCTS * (3 if fp2 else 1)
    join = (W - 1) * (4 * dbl + prods) * mont_mul_imads(n_limbs)
    nbytes = W * rows * NT * pb + rows * pb
    return nbytes, add_imads(n_limbs, fp2, W * rows * (NT - 1)) + rows * join


def table_work(n_limbs: int, fp2: bool, R: int, B: int) -> int:
    """IMADs of one Straus table build (``straus.table_program``) over R rows
    of B lanes: 16 complete additions a lane."""
    return add_imads(n_limbs, fp2, TABLE * R * B)


def bound(nbytes: float, imads: float) -> tuple[float, str]:
    """The least milliseconds the card could take: the larger of the bytes
    over HBM's rate and the IMADs over the IMAD peak, and which it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = imads / IMAD_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def throughput_line(metric: str, work_u32_mults: int, seconds: float, imads: int) -> str:
    """One JSON line: the reference's fields (its u32-multiply count and
    rate) and the card's IMADs, their rate, and that rate against the IMAD
    peak and the fastest measured field-product kernel."""
    s = max(seconds, 1e-9)
    rate = imads / s
    return json.dumps(
        {
            "metric": metric,
            "u32_mults": work_u32_mults,
            "seconds": round(seconds, 4),
            "u32_mults_per_sec": round(work_u32_mults / s),
            "imads": imads,
            "imads_per_sec": round(rate),
            "mfu_vs_imad_peak": round(rate / IMAD_PER_S, 4),
            "mfu_vs_kernel_peak": round(rate / KERNEL_PEAK_IMAD_PER_S, 4),
        }
    )
