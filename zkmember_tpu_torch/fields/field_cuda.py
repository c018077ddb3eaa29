"""K3: batch-major Montgomery product, a hand-written CUDA kernel and its plain version.

Replaces the Pallas kernel ``zkmember_tpu/fields/pallas_field.py::mont_mul``
(``_mont_mul_pallas_2d``).  The kernel is ``csrc/mont_mul_bm.cu``: one
thread per row, CIOS over 32-bit words with 64-bit accumulators, rows read
and written in 16-byte loads and stores; bounded by the bytes it moves,
12 n B per row (288 B at n = 24).

``mont_mul_bm`` takes broadcastable ``(..., n)`` int32 rows of 16-bit limbs
(a ``(n,)`` constant against ``(..., n)`` rows, or a ``(N/2, n)`` twiddle
table against ``(3, N/2, n)`` rows) and returns the fully reduced
a * b * R^-1 mod p in the broadcast shape.  A CUDA tensor goes to the
kernel, broadcast operands uncopied (:func:`launch_args`); a CPU tensor
takes ``mont_mul_bm_plain``, the counterpart of the reference's XLA
pipeline in ``fields.device.mont_mul`` (T = ab; m = T_lo N'; (T + m p) / R;
conditional subtract).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

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


class LaunchArgs(NamedTuple):
    shape: tuple  # the output's shape, the operands' broadcast
    outer: int  # rows = outer x inner, each side folded from the row axes
    inner: int
    a_strides: tuple  # a's element strides over (outer, inner); 0 = broadcast
    b_strides: tuple
    copy_a: bool  # a cannot be read in place: the wrapper copies it (expanded, contiguous)
    copy_b: bool


def _in_place(shape, x_shape, x_strides, aligned: bool):
    """x's expanded row strides, or None where the kernel cannot read x in
    place: limbs not contiguous, or a row start off 16 bytes."""
    st = kernels.expanded_strides(shape, tuple(x_shape), tuple(x_strides))
    if not aligned or st[-1] != 1 or any(s % 4 for s in st[:-1]):
        return None
    return st[:-1]


@functools.lru_cache(maxsize=1024)
def launch_args(n: int, a_shape, a_strides, a_aligned: bool, b_shape, b_strides,
                b_aligned: bool) -> LaunchArgs:
    """The geometry of one K3 launch on (..., n) operands of these shapes and
    element strides (`aligned`: the data starts on 16 bytes).  The row axes
    split into (outer, inner) at the first axis where both operands fold into
    one stride on each side; an operand that no split serves is copied,
    expanded and contiguous, first."""
    shape = kernels.broadcast_shape(tuple(a_shape), tuple(b_shape))
    if len(shape) < 1 or shape[-1] != n:
        raise ValueError(f"expected (..., {n}) rows, got {shape}")
    rows = shape[:-1]
    dense = tuple(d * n for d in kernels.contiguous_strides(rows))  # a copy's row strides
    st = [_in_place(shape, a_shape, a_strides, a_aligned),
          _in_place(shape, b_shape, b_strides, b_aligned)]
    copy = [s is None for s in st]
    st = [dense if s is None else s for s in st]

    def split(p):
        """Both operands' (outer, inner) strides with the row axes split at p."""
        out = []
        for s in st:
            o, i = kernels.fold(rows[:p], s[:p]), kernels.fold(rows[p:], s[p:])
            if o is None or i is None:
                return None
            out.append((o, i))
        return out

    p, folded = 0, None
    for p in range(max(len(rows), 1)):
        folded = split(p)
        if folded is not None:
            break
    if folded is None:  # copy what does not fold over all rows; read them as one axis
        p = 0
        for j in (0, 1):
            if kernels.fold(rows, st[j]) is None:
                copy[j], st[j] = True, dense
        folded = split(0)
    outer = inner = 1
    for size in rows[:p]:
        outer *= size
    for size in rows[p:]:
        inner *= size
    return LaunchArgs(shape, outer, inner, folded[0], folded[1], copy[0], copy[1])


def prepare(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor):
    """Check two CUDA operands and make one launch of the kernel: its
    arguments but the stream, the output, and the operands they point into."""
    n = spec.n
    if n not in SUPPORTED_N:
        raise ValueError(f"mont_mul_bm kernel supports n in {SUPPORTED_N}, got {n}")
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError("mont_mul_bm rows must be torch.int32")
    if not (a.is_cuda and b.is_cuda) or a.device != b.device:
        raise ValueError("mont_mul_bm kernel needs both operands on the same CUDA device")
    g = launch_args(n, a.shape, a.stride(), a.data_ptr() % 16 == 0,
                    b.shape, b.stride(), b.data_ptr() % 16 == 0)
    if g.copy_a:
        a = a.expand(g.shape).clone(memory_format=torch.contiguous_format)
    if g.copy_b:
        b = b.expand(g.shape).clone(memory_format=torch.contiguous_format)
    out = torch.empty(g.shape, dtype=torch.int32, device=a.device)
    p_words, np0 = kernels.field_consts(spec)
    args = (n, a.data_ptr(), b.data_ptr(), out.data_ptr(), g.outer, g.inner, *g.a_strides,
            *g.b_strides, p_words, np0)
    return args, out, (a, b)


def mont_mul_bm_cuda(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on (broadcastable) int32 rows on one card."""
    args, out, _operands = prepare(spec, a, b)
    if out.numel():
        kernels.check(kernels.launch(kernels.library().zk_mont_mul_bm, out.device, *args),
                      "mont_mul_bm")
        kernels.LAUNCHES["mont_mul_bm"] += 1
    return out


def mont_mul_bm(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Kernel for CUDA tensors, plain version for CPU tensors."""
    if a.is_cuda or b.is_cuda:
        return mont_mul_bm_cuda(spec, a, b)
    return mont_mul_bm_plain(spec, a, b)
