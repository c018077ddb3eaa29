"""K2: limb-major Montgomery product, a hand-written CUDA kernel and its plain version.

Replaces the Pallas kernel ``zkmember_tpu/fields/lm_pallas.py::mont_mul``
(``_mont_mul_pallas_3d``).  The kernel is ``csrc/mont_mul.cu``: lanes and
planes on a 2-D grid, CIOS over 32-bit words with 64-bit accumulators,
operands read through element strides, bounded by the bytes it moves,
288 B per element at n = 24 (see the source for the bound).

``mont_mul`` takes ``(..., n, B)`` int32 planes (broadcastable) and returns
the fully reduced a * b * R^-1 mod p.  A CUDA tensor goes to the kernel;
a CPU tensor takes ``mont_mul_plain``, the counterpart of the reference's
``fields.lm.mont_mul_xla`` (same separated-operand pipeline).  A broadcast
operand -- a stage's (n, B) twiddles against a (3, n, B) stack, an (n, 1)
constant column -- reaches the kernel uncopied (:func:`launch_args`).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from zkmember_tpu_torch import kernels
from zkmember_tpu_torch.fields import limbs as lb
from zkmember_tpu_torch.fields.spec import FieldSpec

SUPPORTED_N = (16, 24, 48)


def mont_mul_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch Montgomery product: T = ab; m = T_lo N' mod R;
    S = T + m p; out = S / R, conditionally minus p."""
    n = spec.n
    dev = a.device
    T = lb.carry(lb.mul_cols(a.long(), b.long()), 2 * n)
    NP = lb.const_limbs(spec.nprime_limbs, dev, torch.int64)
    P = lb.const_limbs(spec.p_limbs, dev, torch.int64)
    m = lb.carry(lb.mul_cols(T[..., :n, :], NP), n)
    U = lb.mul_cols(m, P)  # 2n - 1 columns
    S = lb.carry(T + torch.nn.functional.pad(U, (0, 0, 0, 1)), 2 * n + 1)
    out = lb.cond_sub_p(spec, S[..., n : 2 * n, :], S[..., 2 * n, :]).to(torch.int32)
    # the operands' broadcast shape, as the kernel gives: a (1, n, B) plane
    # times an (n, 1) constant came out (n, B)
    shape = kernels.broadcast_shape(tuple(a.shape), tuple(b.shape))
    return out if tuple(out.shape) == shape else out.expand(shape).contiguous()


class LaunchArgs(NamedTuple):
    shape: tuple  # the output's shape, the operands' broadcast
    K: int  # planes: the leading axes, folded
    B: int  # lanes
    a_strides: tuple  # a's element strides over (K, limb, lane); 0 = broadcast
    b_strides: tuple
    copy_a: bool  # a's leading axes fold into no single stride: the wrapper copies it
    copy_b: bool


@functools.lru_cache(maxsize=1024)
def launch_args(n: int, a_shape, a_strides, b_shape, b_strides) -> LaunchArgs:
    """The geometry of one K2 launch on (..., n, B) operands of these shapes
    and element strides: each operand is read in place through three strides
    over (K, limb, lane), unless its leading axes do not fold into one stride;
    such an operand is copied, expanded and contiguous, first."""
    shape = kernels.broadcast_shape(tuple(a_shape), tuple(b_shape))
    if len(shape) < 2 or shape[-2] != n:
        raise ValueError(f"expected (..., {n}, B) planes, got {shape}")
    lead, B = shape[:-2], shape[-1]
    K = 1
    for size in lead:
        K *= size
    strides, copies = [], []
    for x_shape, x_strides in ((a_shape, a_strides), (b_shape, b_strides)):
        st = kernels.expanded_strides(shape, tuple(x_shape), tuple(x_strides))
        k = kernels.fold(lead, st[:-2])
        copies.append(k is None)
        strides.append((n * B, B, 1) if k is None else (k, st[-2], st[-1]))
    return LaunchArgs(shape, K, B, strides[0], strides[1], copies[0], copies[1])


def prepare(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor):
    """Check two CUDA operands and make one launch of the kernel: its
    arguments but the stream, the output, and the operands they point into."""
    n = spec.n
    if n not in SUPPORTED_N:
        raise ValueError(f"mont_mul kernel supports n in {SUPPORTED_N}, got {n}")
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError("mont_mul planes must be torch.int32")
    if not (a.is_cuda and b.is_cuda) or a.device != b.device:
        raise ValueError("mont_mul kernel needs both planes on the same CUDA device")
    g = launch_args(n, a.shape, a.stride(), b.shape, b.stride())
    if g.copy_a:
        a = a.expand(g.shape).contiguous()
    if g.copy_b:
        b = b.expand(g.shape).contiguous()
    out = torch.empty(g.shape, dtype=torch.int32, device=a.device)
    p_words, np0 = kernels.field_consts(spec)
    args = (n, a.data_ptr(), b.data_ptr(), out.data_ptr(), g.K, g.B, *g.a_strides,
            *g.b_strides, p_words, np0)
    return args, out, (a, b)


def mont_mul_cuda(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on (broadcastable) int32 planes on one card."""
    args, out, _operands = prepare(spec, a, b)
    if out.numel():
        kernels.check(kernels.launch(kernels.library().zk_mont_mul, out.device, *args),
                      "mont_mul")
        kernels.LAUNCHES["mont_mul"] += 1
    return out


def mont_mul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Kernel for CUDA tensors, plain version for CPU tensors."""
    if a.is_cuda or b.is_cuda:
        return mont_mul_cuda(spec, a, b)
    return mont_mul_plain(spec, a, b)
