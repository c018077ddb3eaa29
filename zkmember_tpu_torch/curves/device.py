"""Projective short-Weierstrass ops on limb-major planes (counterpart of the
projective subset of zkmember_tpu.curves.device).

Points are (X, Y, Z) coordinate tuples whose entries are field elements of
the ops' field vtable: limb-major planes (``fields.lm.FpOpsLM`` or
``Fp2OpsLM``) or batch-major rows (``fields.device.FpOps`` or ``Fp2Ops``),
which share one stacked interface; the identity is (0, 1, 0).  Additions
use the complete RCB a = 0 law, so doubling is addition and no input is
exceptional.
"""

from __future__ import annotations

import torch


class SWOps:
    """a=0 short-Weierstrass curve ops bundle for the RCB complete formulas.

    b3: 3*b as a small signed int (base-field curves) or an (int, int) pair
    (Fp2 curves, b3 = c0 + c1*u)."""

    def __init__(self, F, b3, name: str):
        self.F = F
        self.b3 = b3
        self.name = name

    def __repr__(self):
        return f"SWOps({self.name})"


def b3_of(curve):
    """3 b of a host a = 0 SW curve as a small signed int, or an (int, int)
    pair c0 + c1 u for a curve over Fp2."""
    field = curve.field
    p = field.base.p if hasattr(field, "base") else field.p

    def small(v: int) -> int:
        s = v if v <= p // 2 else v - p
        if abs(s) >= 1 << 16:
            raise ValueError("curve b3 is not small")
        return s

    b = curve.b
    if hasattr(b, "coeffs"):
        return tuple(small(int(c.v) * 3 % p) for c in b.coeffs)
    return small(int(b.v) * 3 % p)


def swp_identity(ops: SWOps, shape=()):
    F = ops.F
    return (F.zeros(shape), F.ones(shape), F.zeros(shape))


def swp_is_identity(ops: SWOps, P):
    return ops.F.is_zero(P[2])


def swp_from_affine(ops: SWOps, x, y):
    F = ops.F
    return (x, y, F.ones(F.batch_shape(x)))


def swp_add(ops: SWOps, P, Q):
    """Complete projective addition (RCB15 Alg. 7, a=0): 12M, branchless.

    Independent field operations of each dependency wave are issued as ONE
    stacked operation (F.add_many / sub_many / mul_many / mul_consts): the
    same values as the reference's op-by-op order, in a few wide launches."""
    F = ops.F
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    s = F.add_many([(X1, Y1), (X2, Y2), (Y1, Z1), (Y2, Z2), (X1, Z1), (X2, Z2)])
    t0, t1, t2, t3, t4, ty = F.mul_many(
        [(X1, X2), (Y1, Y2), (Z1, Z2), (s[0], s[1]), (s[2], s[3]), (s[4], s[5])]
    )
    u = F.add_many([(t0, t1), (t1, t2), (t0, t2)])
    t3, t4, ty = F.sub_many([(t3, u[0]), (t4, u[1]), (ty, u[2])])  # X1Y2 + X2Y1, ...
    t0, t2, ty = F.mul_consts([t0, t2, ty], [3, ops.b3, ops.b3])  # 3 X1X2, b3 Z1Z2, ...
    Z3 = F.add(t1, t2)  # Y1Y2 + b3 Z1Z2
    t1 = F.sub(t1, t2)  # Y1Y2 - b3 Z1Z2
    m0, m1, m2, m3, m4, m5 = F.mul_many(
        [(t3, t1), (t4, ty), (ty, t0), (t1, Z3), (Z3, t4), (t0, t3)]
    )
    Y3, Z3 = F.add_many([(m2, m3), (m4, m5)])
    return (F.sub(m0, m1), Y3, Z3)


def swp_double(ops: SWOps, P):
    """Complete projective doubling (RCB15 Alg. 9, a=0): 7M, branchless."""
    F = ops.F
    X, Y, Z = P
    t0, t1, zz, xy = F.mul_many([(Y, Y), (Y, Z), (Z, Z), (X, Y)])
    Z3, t2 = F.mul_consts([t0, zz], [8, ops.b3])  # 8Y^2, b3 Z^2
    Y3 = F.add(t0, t2)
    t0 = F.sub(t0, F.mul_consts([t2], [3])[0])
    X3w, Z3w, Y3w, XYw = F.mul_many(
        [(t2, Z3), (t1, Z3), (t0, Y3), (t0, xy)]
    )
    return (F.double(XYw), F.add(X3w, Y3w), Z3w)


def swp_select(ops: SWOps, mask, P, Q):
    F = ops.F
    return tuple(F.select(mask, a, b) for a, b in zip(P, Q))


def swp_to_affine(ops: SWOps, P):
    """Batch-normalize projective -> affine (x, y, is_identity).  One Fermat
    inversion of Z for the whole batch; the identity maps to (0, 0)."""
    F = ops.F
    X, Y, Z = P
    zinv = F.inv(Z)
    x, y = F.mul_many([(X, zinv), (Y, zinv)])
    return x, y, swp_is_identity(ops, P)


def swp_msm_bool(ops: SWOps, mask, P):
    """MSM with 0/1 scalars along axis 0: mask to the identity, one tree
    reduction."""
    ident = swp_identity(ops, ops.F.batch_shape(P[0]))
    return swp_tree_reduce(ops, swp_select(ops, mask != 0, P, ident))


def gather_coord(c, idx):
    """Rows of a coordinate (tuple aware) by index along axis 0."""
    return _map(lambda ci: ci[idx], c)


def _map(f, c):
    if isinstance(c, tuple):
        return tuple(_map(f, ci) for ci in c)
    return f(c)


def swp_tree_reduce(ops: SWOps, P):
    """Sum a batch of projective points along axis 0 (log2 rounds of adds).

    Padding slots are the projective identity, which the complete law
    absorbs; round k adds even slot 2i and odd slot 2i+1."""
    F = ops.F
    B = _leading0(P[0])
    m = 1
    while m < B:
        m *= 2
    if m != B:
        ident = swp_identity(ops, (m - B,) + F.batch_shape(P[0])[1:])
        P = tuple(
            _map2(lambda c, f: torch.cat([c, f], dim=0), c, f) for c, f in zip(P, ident)
        )
    while m > 1:
        even = tuple(_map(lambda c: c[0::2], c) for c in P)
        odd = tuple(_map(lambda c: c[1::2], c) for c in P)
        P = swp_add(ops, even, odd)
        m //= 2
    return tuple(_map(lambda c: c[0], c) for c in P)


def _map2(f, a, b):
    if isinstance(a, tuple):
        return tuple(_map2(f, ai, bi) for ai, bi in zip(a, b))
    return f(a, b)


def _leading0(c):
    while isinstance(c, tuple):
        c = c[0]
    return c.shape[0]
