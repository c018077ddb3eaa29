"""Curve ops over device field elements (counterpart of zkmember_tpu.curves.device).

Jacobian short Weierstrass (``sw_*``, a = 0): (X, Y, Z) with affine
(X/Z^2, Y/Z^3) and Z = 0 the point at infinity, over the batch-major field
vtables (``fields.device.FpOps`` / ``Fp2Ops``, every product on K3 on the
card).  The addition handles doubling, P + (-P) and infinity by masks, in
the reference's formula order (dbl-2009-l, add-2007-bl), so coordinates
match the reference's limb for limb.  The multi-device path
(``parallel.dist.sharded_msm``) reduces over these.

Projective short Weierstrass (``swp_*``): points are (X, Y, Z) coordinate tuples whose entries are
field elements of the ops' field vtable: limb-major planes
(``fields.lm.FpOpsLM`` or ``Fp2OpsLM``) or batch-major rows
(``fields.device.FpOps`` or ``Fp2Ops``), which share one stacked interface;
the identity is (0, 1, 0).  Additions use the complete RCB a = 0 law, so
doubling is addition and no input is exceptional.

Twisted Edwards (a x^2 + y^2 = 1 + d x^2 y^2): extended coordinates
(X, Y, T, Z) with x = X/Z, y = Y/Z, T = XY/Z over batch-major rows; the
identity is (0, 1, 0, 1).  The unified addition issues the reference's
three product waves (5 + 2 + 4 rows) as three stacked K3 launches.
"""

from __future__ import annotations

import numpy as np
import torch


# ---------------------------------------------------------------------------
# short Weierstrass, a = 0, Jacobian coordinates with masked special cases
# ---------------------------------------------------------------------------


def sw_infinity(F, shape=()):
    return (F.zeros(shape), F.ones(shape), F.zeros(shape))


def sw_is_infinity(F, P):
    return F.is_zero(P[2])


def sw_double(F, P):
    """Jacobian doubling for a = 0 (dbl-2009-l).  Infinity (Z = 0) stays put."""
    X, Y, Z = P
    A = F.sqr(X)
    B = F.sqr(Y)
    C = F.sqr(B)
    t = F.sqr(F.add(X, B))
    D = F.double(F.sub(F.sub(t, A), C))  # 2((X + B)^2 - A - C)
    E = F.add(F.double(A), A)  # 3A
    G = F.sqr(E)
    X3 = F.sub(G, F.double(D))
    eight_c = F.double(F.double(F.double(C)))
    Y3 = F.sub(F.mul(E, F.sub(D, X3)), eight_c)
    Z3 = F.double(F.mul(Y, Z))
    return (X3, Y3, Z3)


def sw_add(F, P, Q):
    """Complete batched Jacobian addition (add-2007-bl), the special cases
    by masks: P == Q doubles, P == -Q gives infinity, and an input at
    infinity returns the other (applied last)."""
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    Z1Z1 = F.sqr(Z1)
    Z2Z2 = F.sqr(Z2)
    U1 = F.mul(X1, Z2Z2)
    U2 = F.mul(X2, Z1Z1)
    S1 = F.mul(Y1, F.mul(Z2, Z2Z2))
    S2 = F.mul(Y2, F.mul(Z1, Z1Z1))
    H = F.sub(U2, U1)
    R = F.sub(S2, S1)

    HH = F.sqr(H)
    HHH = F.mul(H, HH)
    V = F.mul(U1, HH)
    X3 = F.sub(F.sub(F.sqr(R), HHH), F.double(V))
    Y3 = F.sub(F.mul(R, F.sub(V, X3)), F.mul(S1, HHH))
    Z3 = F.mul(H, F.mul(Z1, Z2))
    out = (X3, Y3, Z3)

    dbl = sw_double(F, P)
    h_zero = F.is_zero(H)
    r_zero = F.is_zero(R)
    inf = sw_infinity(F, F.batch_shape(Z1))
    for mask, pick in ((h_zero & r_zero, dbl), (h_zero & ~r_zero, inf),
                       (F.is_zero(Z2), P), (F.is_zero(Z1), Q)):
        out = tuple(F.select(mask, a, b) for a, b in zip(pick, out))
    return out


def sw_cond_add(F, P, Q, bit):
    """P + Q where bit is nonzero, else P (bit: batch-shaped)."""
    S = sw_add(F, P, Q)
    m = bit != 0
    return tuple(F.select(m, s, p) for s, p in zip(S, P))


def sw_neg(F, P):
    return (P[0], F.neg(P[1]), P[2])


def _bits(F, bits):
    """0/1 or digit rows (numpy or a tensor) as a tensor on F's device."""
    return torch.as_tensor(np.asarray(bits).astype(np.int64) if not isinstance(
        bits, torch.Tensor) else bits, device=F.device)


def sw_scalar_mul(F, scalar_bits, P):
    """Batched double-and-add: scalar_bits (B, nbits), MSB first (the
    reference's lax.scan as a loop: one doubling and one masked addition a
    bit)."""
    bits = _bits(F, scalar_bits)
    acc = sw_infinity(F, F.batch_shape(P[0]))
    for k in range(bits.shape[-1]):
        acc = sw_cond_add(F, sw_double(F, acc), P, bits[..., k])
    return acc


def sw_scalar_mul_windowed(F, digits, P, c_bits: int = 4):
    """Batched windowed scalar multiplication: digits (B, n_windows), most
    significant window first, each below 2^c_bits.  The table [0]P ..
    [2^c - 1]P by additions, then per window c doublings, one row gather and
    one addition."""
    dig = _bits(F, digits)
    acc = sw_infinity(F, F.batch_shape(P[0]))
    tab, prev = [], acc
    for _ in range(1 << c_bits):
        tab.append(prev)
        prev = sw_add(F, prev, P)
    stacked = tuple(_stack([t[i] for t in tab]) for i in range(3))
    for w in range(dig.shape[-1]):
        for _ in range(c_bits):
            acc = sw_double(F, acc)
        acc = sw_add(F, acc, tuple(_map(lambda c: _take_entry(c, dig[..., w]), x)
                                   for x in stacked))
    return acc


def _stack(cs):
    """Coordinates (tuple aware) stacked on a new leading axis."""
    if isinstance(cs[0], tuple):
        return tuple(_stack([c[i] for c in cs]) for i in range(len(cs[0])))
    return torch.stack(cs)


def _take_entry(c, idx):
    """c (T, B..., n), idx (B...) -> (B..., n): entry idx of each row."""
    i = idx.long().reshape((1,) + tuple(idx.shape) + (1,) * (c.ndim - 1 - idx.ndim))
    return torch.gather(c, 0, i.expand((1,) + tuple(c.shape[1:])))[0]


def sw_to_affine(F, P):
    """Batch-normalize Jacobian -> affine (x, y, is_infinity); one Fermat
    inversion of Z (inv(0) = 0: infinity maps to (0, 0))."""
    X, Y, Z = P
    zinv = F.inv(Z)
    zinv2 = F.sqr(zinv)
    x = F.mul(X, zinv2)
    y = F.mul(Y, F.mul(zinv2, zinv))
    return x, y, sw_is_infinity(F, P)


def sw_tree_reduce(F, P):
    """Sum a batch of Jacobian points along axis 0; coordinates (B, ..., n),
    B any count.  The batch is padded with all-zero rows (Z = 0: infinity)
    to a power of two, then even slot 2i and odd slot 2i + 1 are added
    round by round, as the reference's scan does.  Returns batch shape (...)."""
    B = _leading0(P[0])
    m = 1 << max(0, (B - 1).bit_length())
    if m != B:
        P = tuple(_map(lambda c: torch.nn.functional.pad(
            c, (0, 0) * (c.ndim - 1) + (0, m - B)), x) for x in P)
    while m > 1:
        P = sw_add(F, tuple(_map(lambda c: c[0::2], x) for x in P),
                   tuple(_map(lambda c: c[1::2], x) for x in P))
        m //= 2
    return tuple(_map(lambda c: c[0], x) for x in P)


def sw_msm(F, scalar_bits, P):
    """Variable-base MSM sum_i s_i P_i: scalar_bits (B, nbits) MSB first,
    P Jacobian (B, ...); per-point double-and-add, then ``sw_tree_reduce``."""
    return sw_tree_reduce(F, sw_scalar_mul(F, scalar_bits, P))


def sw_msm_bool(F, mask, P):
    """MSM with 0/1 scalars: a masked select to infinity, one tree reduction."""
    inf = sw_infinity(F, F.batch_shape(P[0]))
    m = _bits(F, mask) != 0
    return sw_tree_reduce(F, tuple(F.select(m, p, i) for p, i in zip(P, inf)))


# ---------------------------------------------------------------------------
# short Weierstrass, a = 0, complete projective formulas (RCB15)
# ---------------------------------------------------------------------------


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


# ---------------------------------------------------------------------------
# twisted Edwards, extended coordinates, unified complete addition
# ---------------------------------------------------------------------------


class TEConsts:
    """Curve constants a, d as Montgomery-form (n,) limb vectors."""

    def __init__(self, a_mont, d_mont):
        self.a = np.asarray(a_mont)
        self.d = np.asarray(d_mont)


def te_identity(F, shape=()):
    return (F.zeros(shape), F.ones(shape), F.zeros(shape), F.ones(shape))


def _row(F, q, shape):
    """A constant (n,) or (..., n) operand expanded over `shape`."""
    if isinstance(q, torch.Tensor):
        return q.to(F.device).expand(tuple(shape) + (q.shape[-1],))
    return F.broadcast_const(q, shape)


def te_add(F, C: TEConsts, P, Q):
    """Unified extended addition (add-2008-hwcd), complete for our curves:
    three stacked product waves of 5, 2 and 4 rows, as in the reference.
    The stacks copy their operands (strided views included) into one
    contiguous (k, ..., n) tensor; K3 reads that in place."""
    X1, Y1, T1, Z1 = P
    X2, Y2, T2, Z2 = Q
    shape = F.batch_shape(X1)
    a = F.broadcast_const(C.a, shape)
    d = F.broadcast_const(C.d, shape)
    A, B, D, Emul, dT1 = F.mul_many(
        [(X1, X2), (Y1, Y2), (Z1, Z2), (F.add(X1, Y1), F.add(X2, Y2)), (d, T1)]
    )
    Cc, aA = F.mul_many([(dT1, T2), (a, A)])
    E = F.sub(F.sub(Emul, A), B)
    Fv = F.sub(D, Cc)
    G = F.add(D, Cc)
    H = F.sub(B, aA)
    return tuple(F.mul_many([(E, Fv), (G, H), (E, H), (Fv, G)]))


def te_add_affine_const(F, C: TEConsts, P, qx_mont, qy_mont):
    """P + Q for a constant affine Q ((n,) or (..., n) Montgomery limbs,
    numpy or a tensor) broadcast over the batch: Z2 = 1, T2 = qx qy.  Three
    stacked product waves (5 + 2 + 4 rows)."""
    X1, Y1, T1, Z1 = P
    shape = F.batch_shape(X1)
    qx, qy = _row(F, qx_mont, shape), _row(F, qy_mont, shape)
    a = F.broadcast_const(C.a, shape)
    d = F.broadcast_const(C.d, shape)
    A, B, T2, Emul, dT1 = F.mul_many(
        [(X1, qx), (Y1, qy), (qx, qy), (F.add(X1, Y1), F.add(qx, qy)), (d, T1)]
    )
    Cc, aA = F.mul_many([(dT1, T2), (a, A)])
    E = F.sub(F.sub(Emul, A), B)
    Fv = F.sub(Z1, Cc)
    G = F.add(Z1, Cc)
    H = F.sub(B, aA)
    return tuple(F.mul_many([(E, Fv), (G, H), (E, H), (Fv, G)]))


def te_cond_add_affine(F, C: TEConsts, P, qx_mont, qy_mont, bit):
    """P + Q if bit else P (constant affine Q): the per-bit Pedersen step."""
    S = te_add_affine_const(F, C, P, qx_mont, qy_mont)
    m = bit != 0
    return tuple(F.select(m, s, p) for s, p in zip(S, P))


def te_double(F, C: TEConsts, P):
    return te_add(F, C, P, P)


def te_scalar_mul(F, C: TEConsts, scalar_bits, P):
    """Batched double-and-add over extended TE points; scalar_bits is
    (..., nbits), MSB first (the reference's lax.scan as a Python loop)."""
    acc = te_identity(F, F.batch_shape(P[0]))
    for k in range(scalar_bits.shape[-1]):
        acc = te_double(F, C, acc)
        S = te_add(F, C, acc, P)
        m = scalar_bits[..., k] != 0
        acc = tuple(F.select(m, s, a) for s, a in zip(S, acc))
    return acc


def te_to_affine(F, P):
    """(x, y) in Montgomery form: one Fermat inversion of Z for the batch,
    then both products in one stacked launch."""
    X, Y, _, Z = P
    zinv = F.inv(Z)
    x, y = F.mul_many([(X, zinv), (Y, zinv)])
    return x, y
