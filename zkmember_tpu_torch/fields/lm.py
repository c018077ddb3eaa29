"""Limb-major field arithmetic on int32 planes (counterpart of zkmember_tpu.fields.lm).

A batch of field elements is an ``(..., n, B)`` ``torch.int32`` tensor of
16-bit limbs in Montgomery form (R = 2^(16 n)); leading axes are free
structure.  Products go through ``lm_cuda.mont_mul`` (kernel K2 for CUDA
tensors, its plain version for CPU tensors); additions, subtractions and
selects are plain PyTorch ops on whatever device the planes live on.
Every result is fully reduced into [0, p), so planes match the
reference's bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from zkmember_tpu_torch.fields import limbs as lb
from zkmember_tpu_torch.fields.lm_cuda import mont_mul
from zkmember_tpu_torch.fields.spec import FieldSpec, Fp2Spec

def const_col(spec: FieldSpec, v: int, device) -> torch.Tensor:
    """Single Montgomery-form constant as an (n, 1) column (broadcasts)."""
    return lb.const_limbs(spec.mont_scalar(v), device)


def add(spec: FieldSpec, a, b):
    s, extra = lb.propagate(a + b)
    return lb.cond_sub_p(spec, s, extra)


def sub(spec: FieldSpec, a, b):
    d, borrow = lb.sub_limbs(a, b)
    dp, _ = lb.propagate(d + lb.const_limbs(spec.p_limbs, d.device, d.dtype))
    return torch.where((borrow == 1).unsqueeze(-2), dp, d)


def neg(spec: FieldSpec, a):
    return sub(spec, torch.zeros_like(a), a)


def zeros(spec: FieldSpec, shape, device):
    """shape = batch shape (..., B); the limb axis goes before the last."""
    shape = tuple(shape)
    return torch.zeros(shape[:-1] + (spec.n,) + shape[-1:], dtype=torch.int32, device=device)


def ones(spec: FieldSpec, shape, device):
    shape = tuple(shape)
    one = lb.const_limbs(spec.one_mont, device)
    return one.expand(shape[:-1] + (spec.n,) + shape[-1:]).clone()


def is_zero(spec: FieldSpec, a):
    return (a == 0).all(dim=-2)


def select(mask, a, b):
    """mask: batch-shaped (..., B) bool -> elementwise select."""
    return torch.where(mask.unsqueeze(-2), a, b)


def mont_pow_static(spec: FieldSpec, a, exp_bits: np.ndarray):
    """a^e for static MSB-first exponent bits (square and multiply)."""
    acc = lb.const_limbs(spec.one_mont, a.device).expand(a.shape)
    for bit in exp_bits:
        acc = mont_mul(spec, acc, acc)
        if bit:
            acc = mont_mul(spec, acc, a)
    return acc


def inv(spec: FieldSpec, a):
    """Batched inverse via Fermat; inv(0) = 0."""
    return mont_pow_static(spec, a, spec.inv_exp_bits)


def from_mont(spec: FieldSpec, a):
    one = np.zeros(spec.n, np.int64)
    one[0] = 1
    return mont_mul(spec, a, lb.const_limbs(one, a.device))  # an (n, 1) column


def to_mont(spec: FieldSpec, a):
    return mont_mul(spec, a, lb.const_limbs(spec.r2_limbs, a.device))


# ---------------------------------------------------------------------------
# vtables (generic curve code dispatches through these)
# ---------------------------------------------------------------------------


class FpOpsLM:
    """Limb-major field-op vtable; elements are (..., n, B) int32 planes.

    Batch shape (for masks/identities) is element.shape with the limb axis
    removed: (..., B).  Constants are built on `device`."""

    def __init__(self, spec: FieldSpec, device):
        self.spec = spec
        self.device = torch.device(device)

    def mul(self, a, b):
        return mont_mul(self.spec, a, b)

    def mul_many(self, pairs):
        """k independent products as ONE stacked mul on a new leading axis."""
        if len(pairs) == 1:
            return [self.mul(*pairs[0])]
        shape = torch.broadcast_shapes(*(x.shape for p in pairs for x in p))
        A = torch.stack([a.expand(shape) for a, _ in pairs])
        B = torch.stack([b.expand(shape) for _, b in pairs])
        out = mont_mul(self.spec, A, B)
        return list(out.unbind(0))

    def _stacked(self, fn, pairs):
        if len(pairs) == 1:
            return [fn(self.spec, *pairs[0])]
        shape = torch.broadcast_shapes(*(x.shape for p in pairs for x in p))
        A = torch.stack([a.expand(shape) for a, _ in pairs])
        B = torch.stack([b.expand(shape) for _, b in pairs])
        return list(fn(self.spec, A, B).unbind(0))

    def add_many(self, pairs):
        """k independent additions as ONE stacked addition."""
        return self._stacked(add, pairs)

    def sub_many(self, pairs):
        """k independent subtractions as ONE stacked subtraction."""
        return self._stacked(sub, pairs)

    def mul_consts(self, xs, ks):
        """[x_i * k_i] for small signed ints k_i, as ONE stacked product with
        the constants' Montgomery forms."""
        consts = torch.stack([const_col(self.spec, k, self.device) for k in ks])
        return self.mul_many(list(zip(xs, consts.unbind(0))))

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
        return (a == b).all(dim=-2)

    def select(self, mask, a, b):
        return select(mask, a, b)

    def inv(self, a):
        return inv(self.spec, a)

    def batch_shape(self, a):
        return tuple(a.shape[:-2]) + tuple(a.shape[-1:])

    def const(self, v: int):
        return const_col(self.spec, v, self.device)


class Fp2OpsLM:
    """Fp2 vtable: elements are (c0, c1) pairs of base-field elements.

    Every base-field operation goes through ``self.base`` (an FpOpsLM here;
    ``fields.device.Fp2Ops`` reuses the class over the batch-major FpOps),
    so the class is the same for either layout."""

    base_ops = FpOpsLM

    def __init__(self, spec: Fp2Spec, device):
        self.spec = spec
        self.base = self.base_ops(spec.base, device)
        self.device = self.base.device

    def _mul_nr(self, v):
        if self.spec.nonresidue == self.spec.base.p - 1:
            return self.base.neg(v)
        return self.base.mul(v, self.base.const(self.spec.nonresidue))

    def mul(self, a, b):
        return self.mul_many([(a, b)])[0]

    def mul_many(self, pairs):
        """Karatsuba, fully stacked: ONE base mul of 3k rows."""
        F = self.base
        k = len(pairs)
        shape = np.broadcast_shapes(
            *(c.shape for a, b in pairs for pair in (a, b) for c in pair)
        )

        def stk(items):
            return torch.stack([c.expand(shape) for c in items])

        A0 = stk([a[0] for a, _ in pairs])
        A1 = stk([a[1] for a, _ in pairs])
        B0 = stk([b[0] for _, b in pairs])
        B1 = stk([b[1] for _, b in pairs])
        S = F.add(torch.cat([A0, B0]), torch.cat([A1, B1]))  # a0 + a1, b0 + b1
        prods = F.mul(torch.cat([A0, A1, S[:k]]), torch.cat([B0, B1, S[k:]]))
        v0 = prods[:k]
        v1 = prods[k : 2 * k]
        t = prods[2 * k :]
        if self.spec.nonresidue == self.spec.base.p - 1:
            c0 = F.sub(v0, v1)
        else:
            c0 = F.add(v0, self._mul_nr(v1))
        c1 = F.sub(t, F.add(v0, v1))
        return [(c0[i], c1[i]) for i in range(k)]

    def _flat(self, fn, pairs):
        flat = [(a[i], b[i]) for a, b in pairs for i in range(2)]
        out = fn(flat)
        return [(out[2 * j], out[2 * j + 1]) for j in range(len(pairs))]

    def add_many(self, pairs):
        return self._flat(self.base.add_many, pairs)

    def sub_many(self, pairs):
        return self._flat(self.base.sub_many, pairs)

    def mul_consts(self, xs, ks):
        """[x_i * k_i] for small constants k_i = c0 + c1 u (ints, or (c0, c1)
        pairs), u^2 = -1: one stacked base product of 4 rows per item."""
        if self.spec.nonresidue != self.spec.base.p - 1:
            raise ValueError("mul_consts assumes the nonresidue -1")
        rows, cs = [], []
        for x, k in zip(xs, ks):
            c0, c1 = k if isinstance(k, tuple) else (k, 0)
            rows += [x[0], x[1], x[1], x[0]]
            cs += [c0, c1, c0, c1]
        p = self.base.mul_consts(rows, cs)  # a0 c0, a1 c1, a1 c0, a0 c1 per item
        n = len(xs)
        r0 = self.base.sub_many([(p[4 * i], p[4 * i + 1]) for i in range(n)])
        r1 = self.base.add_many([(p[4 * i + 2], p[4 * i + 3]) for i in range(n)])
        return list(zip(r0, r1))

    def sqr(self, a):
        F = self.base
        a0, a1 = a
        v = F.mul(a0, a1)
        if self.spec.nonresidue == self.spec.base.p - 1:
            c0 = F.mul(F.add(a0, a1), F.sub(a0, a1))
        else:
            t = F.mul(F.add(a0, a1), F.add(a0, self._mul_nr(a1)))
            c0 = F.sub(F.sub(t, v), self._mul_nr(v))
        return (c0, F.add(v, v))

    def add(self, a, b):
        return (self.base.add(a[0], b[0]), self.base.add(a[1], b[1]))

    def sub(self, a, b):
        return (self.base.sub(a[0], b[0]), self.base.sub(a[1], b[1]))

    def neg(self, a):
        return (self.base.neg(a[0]), self.base.neg(a[1]))

    def double(self, a):
        return self.add(a, a)

    def zeros(self, shape=()):
        return (self.base.zeros(shape), self.base.zeros(shape))

    def ones(self, shape=()):
        return (self.base.ones(shape), self.base.zeros(shape))

    def is_zero(self, a):
        return self.base.is_zero(a[0]) & self.base.is_zero(a[1])

    def eq(self, a, b):
        return self.base.eq(a[0], b[0]) & self.base.eq(a[1], b[1])

    def select(self, mask, a, b):
        return (self.base.select(mask, a[0], b[0]), self.base.select(mask, a[1], b[1]))

    def inv(self, a):
        base = self.base
        norm = base.sub(base.sqr(a[0]), self._mul_nr(base.sqr(a[1])))
        ninv = base.inv(norm)
        return (base.mul(a[0], ninv), base.neg(base.mul(a[1], ninv)))

    def batch_shape(self, a):
        return self.base.batch_shape(a[0])
