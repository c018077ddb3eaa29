"""K3: batch-major Montgomery product, a hand-written CUDA kernel and its plain version.

Replaces the Pallas kernel ``zkmember_tpu/fields/pallas_field.py::mont_mul``
(``_mont_mul_pallas_2d``).  The kernel is ``csrc/mont_mul_bm.cu``: one
thread per row, CIOS over 32-bit words with 64-bit accumulators, rows
staged through shared memory so loads and stores stay coalesced; bounded
by the bytes it moves, 12 n B per row (288 B at n = 24).

``mont_mul_bm`` takes broadcastable ``(..., n)`` int32 rows of 16-bit limbs
(a ``(n,)`` constant against ``(..., n)`` rows, or a ``(N/2, n)`` twiddle
table against ``(3, N/2, n)`` rows) and returns the fully reduced
a * b * R^-1 mod p in the broadcast shape.  A CUDA tensor goes to the
kernel; a CPU tensor takes ``mont_mul_bm_plain``, the counterpart of the
reference's XLA pipeline in ``fields.device.mont_mul`` (T = ab;
m = T_lo N'; (T + m p) / R; conditional subtract).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from zkmember_tpu_torch import kernels
from zkmember_tpu_torch.fields import lm_cuda
from zkmember_tpu_torch.fields.spec import FieldSpec

SUPPORTED_N = (16, 24, 48)


def _rows(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor):
    shape = np.broadcast_shapes(a.shape, b.shape)
    if len(shape) < 1 or shape[-1] != spec.n:
        raise ValueError(f"expected (..., {spec.n}) rows, got {tuple(shape)}")
    return shape, a.expand(shape).reshape(-1, spec.n), b.expand(shape).reshape(-1, spec.n)


def mont_mul_bm_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch batch-major Montgomery product: the rows, viewed as
    limb-major (n, rows) planes, go through the separated-operand pipeline
    of ``lm_cuda.mont_mul_plain``."""
    shape, a2, b2 = _rows(spec, a, b)
    return lm_cuda.mont_mul_plain(spec, a2.T.contiguous(), b2.T.contiguous()).T.reshape(shape)


def mont_mul_bm_cuda(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on (broadcastable) int32 rows on one card.
    Broadcast operands are expanded into contiguous rows first."""
    n = spec.n
    if n not in SUPPORTED_N:
        raise ValueError(f"mont_mul_bm kernel supports n in {SUPPORTED_N}, got {n}")
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError("mont_mul_bm rows must be torch.int32")
    if not (a.is_cuda and b.is_cuda) or a.device != b.device:
        raise ValueError("mont_mul_bm kernel needs both operands on the same CUDA device")
    shape, a2, b2 = _rows(spec, a, b)
    a2, b2 = a2.contiguous(), b2.contiguous()
    out = torch.empty_like(a2)
    if out.numel() == 0:
        return out.reshape(shape)
    lib = kernels.library()
    p_words = np.ascontiguousarray(spec.p_words)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.zk_mont_mul_bm(
            n, a2.data_ptr(), b2.data_ptr(), out.data_ptr(), a2.shape[0],
            p_words.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), spec.np32, stream,
        )
    kernels.check(rc, "mont_mul_bm")
    kernels.LAUNCHES["mont_mul_bm"] += 1
    return out.reshape(shape)


def mont_mul_bm(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Kernel for CUDA tensors, plain version for CPU tensors."""
    if a.is_cuda or b.is_cuda:
        return mont_mul_bm_cuda(spec, a, b)
    return mont_mul_bm_plain(spec, a, b)
