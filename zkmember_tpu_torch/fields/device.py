"""Batch-major field arithmetic on int32 rows (counterpart of zkmember_tpu.fields.device).

A batch of field elements is a ``(..., n)`` ``torch.int32`` tensor of 16-bit
limbs in Montgomery form (R = 2^(16 n)), the limb axis last: the layout of
the reference's v1 stack (setup, the Pease NTT of ``ntt.ntt`` and the
Pippenger MSM of ``msm.msm``).  Products go through
``field_cuda.mont_mul_bm``: kernel K3 for CUDA tensors, its plain version for
CPU tensors.  There is no opt-in switch: the reference's ``ZKMEMBER_PALLAS``
(``fields/device.py:289-303``) trades compile time on a TPU, which does not
exist here.

Additions, subtractions and selects are plain PyTorch ops: a row
``(..., n)`` is the limb-major plane ``(..., n, 1)``, so the exact carry
helpers of ``fields.lm`` serve both layouts.  Every result is fully reduced
into [0, p), so rows match the reference's bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from zkmember_tpu_torch.fields import limbs as lb
from zkmember_tpu_torch.fields import lm
from zkmember_tpu_torch.fields.field_cuda import mont_mul_bm as mont_mul
from zkmember_tpu_torch.fields.spec import FieldSpec


def _const(limbs: np.ndarray, device) -> torch.Tensor:
    """A limb vector as an (n,) row on `device` (cached)."""
    return lb.const_limbs(limbs, device).view(-1)


def add(spec: FieldSpec, a, b):
    return lm.add(spec, a.unsqueeze(-1), b.unsqueeze(-1)).squeeze(-1)


def sub(spec: FieldSpec, a, b):
    return lm.sub(spec, a.unsqueeze(-1), b.unsqueeze(-1)).squeeze(-1)


def neg(spec: FieldSpec, a):
    return sub(spec, torch.zeros_like(a), a)


def double(spec: FieldSpec, a):
    return add(spec, a, a)


def zeros(spec: FieldSpec, shape, device):
    return torch.zeros(tuple(shape) + (spec.n,), dtype=torch.int32, device=device)


def ones(spec: FieldSpec, shape, device):
    """1 in Montgomery form."""
    return _const(spec.one_mont, device).expand(tuple(shape) + (spec.n,)).clone()


def is_zero(spec: FieldSpec, a):
    return (a == 0).all(dim=-1)


def eq(spec: FieldSpec, a, b):
    return (a == b).all(dim=-1)


def select(mask, a, b):
    """mask: batch-shaped (...) bool -> elementwise select."""
    return torch.where(mask.unsqueeze(-1), a, b)


def to_mont(spec: FieldSpec, a):
    return mont_mul(spec, a, _const(spec.r2_limbs, a.device))


def from_mont(spec: FieldSpec, a):
    one = torch.zeros(spec.n, dtype=torch.int32, device=a.device)
    one[0] = 1
    return mont_mul(spec, a, one)


def mont_pow_static(spec: FieldSpec, a, exp_bits: np.ndarray):
    """a^e for static MSB-first exponent bits (square and multiply)."""
    acc = _const(spec.one_mont, a.device).expand(a.shape)
    for bit in exp_bits:
        acc = mont_mul(spec, acc, acc)
        if bit:
            acc = mont_mul(spec, acc, a)
    return acc


def inv(spec: FieldSpec, a):
    """Batched inverse via Fermat (a^(p-2)); inv(0) = 0."""
    return mont_pow_static(spec, a, spec.inv_exp_bits)


# ---------------------------------------------------------------------------
# vtables (generic curve code dispatches through these)
# ---------------------------------------------------------------------------


class FpOps:
    """Batch-major field-op vtable; elements are (..., n) int32 rows.

    The same stacked interface as ``fields.lm.FpOpsLM`` (``add_many``,
    ``sub_many``, ``mul_many``, ``mul_consts``, ``batch_shape``, ...), so
    ``curves.device`` serves both layouts.  Batch shape is the element's
    shape without the limb axis; constants are built on `device`."""

    def __init__(self, spec: FieldSpec, device):
        self.spec = spec
        self.device = torch.device(device)

    def _stacked(self, fn, pairs):
        """k independent binary ops as ONE op on a new leading axis."""
        if len(pairs) == 1:
            return [fn(self.spec, *pairs[0])]
        shape = np.broadcast_shapes(*(x.shape for p in pairs for x in p))
        A = torch.stack([a.expand(shape) for a, _ in pairs])
        B = torch.stack([b.expand(shape) for _, b in pairs])
        return list(fn(self.spec, A, B).unbind(0))

    def mul(self, a, b):
        return mont_mul(self.spec, a, b)

    def mul_many(self, pairs):
        """k independent products as ONE stacked K3 launch."""
        return self._stacked(mont_mul, pairs)

    def add_many(self, pairs):
        return self._stacked(add, pairs)

    def sub_many(self, pairs):
        return self._stacked(sub, pairs)

    def mul_consts(self, xs, ks):
        """[x_i * k_i] for small signed ints k_i, as ONE stacked product with
        the constants' Montgomery forms."""
        return self.mul_many([(x, self.const(k)) for x, k in zip(xs, ks)])

    def sqr(self, a):
        return mont_mul(self.spec, a, a)

    def add(self, a, b):
        return add(self.spec, a, b)

    def sub(self, a, b):
        return sub(self.spec, a, b)

    def neg(self, a):
        return neg(self.spec, a)

    def double(self, a):
        return add(self.spec, a, a)

    def zeros(self, shape=()):
        return zeros(self.spec, shape, self.device)

    def ones(self, shape=()):
        return ones(self.spec, shape, self.device)

    def is_zero(self, a):
        return is_zero(self.spec, a)

    def eq(self, a, b):
        return eq(self.spec, a, b)

    def select(self, mask, a, b):
        return select(mask, a, b)

    def inv(self, a):
        return inv(self.spec, a)

    def batch_shape(self, a):
        return tuple(a.shape[:-1])

    def broadcast_const(self, const_limbs, shape):
        """A Montgomery limb vector expanded (not copied) over `shape`."""
        return _const(np.asarray(const_limbs), self.device).expand(tuple(shape) + (self.spec.n,))

    def const(self, v: int):
        """A single Montgomery-form constant as an (n,) row (broadcasts)."""
        return _const(self.spec.mont_scalar(v), self.device)


class Fp2Ops(lm.Fp2OpsLM):
    """Batch-major Fp2 vtable (the reference's ``fp2_*`` and ``Fp2Ops``):
    (c0, c1) pairs of (..., n) rows.  Karatsuba ``mul_many`` is one stacked
    base product of 3k rows."""

    base_ops = FpOps

