"""Straus MSM on limb-major point planes, precomputed-table path
(counterpart of the main-path subset of zkmember_tpu.msm.straus).

    sum_i s_i P_i  =  sum_w 16^w ( sum_i T_i[d_{i,w}] )

with T_i = [0..15] P_i the per-point table (built once per proving key by
``table_program``, in K1's packed layout) and d_{i,w} the w-th 4-bit
digit of s_i.  Kernel K1 (``select_reduce_cuda``) selects and reduces
each lane tile per window; ``tree_reduce_lanes`` finishes the narrow tail
and ``horner_join`` folds the window sums, both in one kernel on the card (``finish_cuda``).  Zero
scalars select entry 0, the identity, so padded lanes vanish.
"""

from __future__ import annotations

import numpy as np
import torch

from zkmember_tpu_torch.curves import device as cdv
from zkmember_tpu_torch.fields.spec import LIMB_BITS
from zkmember_tpu_torch.msm import finish_cuda, select_reduce_cuda

WINDOW_BITS = 4
TABLE = 1 << WINDOW_BITS
TAIL_WIDTH = 256  # contiguous halving above this width, even/odd rounds below


def _map_coord(f, c):
    if isinstance(c, tuple):
        return tuple(_map_coord(f, ci) for ci in c)
    return f(c)


def _lanes(c):
    while isinstance(c, tuple):
        c = c[0]
    return c.shape[-1]


def tree_reduce_lanes(ops, P, keep: int = 1):
    """Sum projective points along the lane axis down to `keep` lanes:
    contiguous half-splits while wider than TAIL_WIDTH, then even/odd
    rounds (the reference's order)."""
    B = _lanes(P[0])
    if B % keep or (B // keep) & (B // keep - 1):
        raise ValueError("lanes / keep must be a power of two")
    tail = min(TAIL_WIDTH, B // keep) * keep
    while B > tail:
        h = B // 2
        left = tuple(_map_coord(lambda c: c[..., :h], x) for x in P)
        right = tuple(_map_coord(lambda c: c[..., h:], x) for x in P)
        P = cdv.swp_add(ops, left, right)
        B = h
    while B > keep:
        even = tuple(_map_coord(lambda c: c[..., 0::2], x) for x in P)
        odd = tuple(_map_coord(lambda c: c[..., 1::2], x) for x in P)
        P = cdv.swp_add(ops, even, odd)
        B //= 2
    return P


def small_table(ops, P1):
    """Per-point multiples [0..15]P as stacked coords (16, ..., n, B);
    entry 0 is the projective identity."""
    F = ops.F
    prev = cdv.swp_identity(ops, F.batch_shape(P1[0]))
    rows = []
    for _ in range(TABLE):
        rows.append(prev)
        prev = cdv.swp_add(ops, prev, P1)

    def stack(*cs):
        if isinstance(cs[0], tuple):
            return tuple(stack(*(c[i] for c in cs)) for i in range(len(cs[0])))
        return torch.stack(cs)

    return tuple(stack(*(r[i] for r in rows)) for i in range(3))


def table_program(ops, X, Y):
    """Straus table of the affine points (X, Y) (..., n, B), as K1's packed
    records (16, R, B, 3 C n/2) (``select_reduce_cuda.pack_records``); it
    depends only on the proving key, so callers build it once."""
    return select_reduce_cuda.pack_records(small_table(ops, cdv.swp_from_affine(ops, X, Y)))


def digits_from_limbs(z, nwin: int):
    """Canonical 16-bit limb planes (..., n, B) -> (nwin, ..., B) 4-bit
    window digits, MOST-significant window first."""
    outs = []
    for w in reversed(range(nwin)):  # w = weight of 16^w
        limb = z[..., w // 4, :]
        outs.append((limb >> (WINDOW_BITS * (w % 4))) & (TABLE - 1))
    return torch.stack(outs)


def horner_join(ops, S):
    """Window sums (coords (W, ..., n, 1), MSW first) -> one point:
    acc = 16 acc + S_w, each doubling as a complete self-addition."""
    F = ops.F
    W = _lanes_leading(S)
    acc = cdv.swp_identity(ops, F.batch_shape(S[0])[1:])
    for w in range(W):
        for _ in range(WINDOW_BITS):
            acc = cdv.swp_add(ops, acc, acc)
        acc = cdv.swp_add(ops, acc, tuple(_map_coord(lambda c: c[w], x) for x in S))
    return acc


def _lanes_leading(S):
    c = S[0]
    while isinstance(c, tuple):
        c = c[0]
    return c.shape[0]


def msm_precomp_program(ops, tab, nwin: int, z, mark=None, prefix: str = ""):
    """MSM from a precomputed table through kernel K1, then the narrow tail
    reduction and the Horner join (``finish_cuda``).  tab: table_program's
    records (16, R, B, 3 C n/2); z ([R,] nl, B) canonical scalar limbs.
    Returns projective coords ([R,] n, 1).  mark: optional phase clock
    (utils.obs.PhaseClock), called after each stage as mark(prefix + stage).
    One proof of ``msm_precomp_batch``."""
    acc = msm_precomp_batch(ops, tab, nwin, z[None], mark, prefix)
    return tuple(_map_coord(lambda c: c[0], x) for x in acc)


def msm_precomp_batch(ops, tab, nwin: int, z, mark=None, prefix: str = ""):
    """P MSMs against ONE precomputed table (the reference's proof-batch
    axis): z (P, [R,] nl, B) holds P proofs' scalars for the same key
    points.  K1 runs once over digits (W, P, [R,] B); the finish runs once
    over the P R rows of its window sums (a view).  Returns projective
    coords with leading (P, [R]): (P, [R,] n, 1).  mark/prefix as in
    ``msm_precomp_program``."""
    mark = mark or (lambda name: None)
    digits = digits_from_limbs(z, nwin).contiguous()  # (W, P, [R,] B)
    squeeze = digits.ndim == 3  # no row axis: R = 1
    if squeeze:
        digits = digits[:, :, None]
    W, P, R, _ = digits.shape
    S = select_reduce_cuda.select_reduce(ops, tab, digits)  # (W, P, R, n, NT)
    mark(prefix + "select_reduce")
    rows = tuple(_map_coord(lambda c: c.reshape((W, P * R) + c.shape[3:]), x) for x in S)
    acc = finish_cuda.msm_finish(ops, rows)  # (P R, n, 1)
    lead = (P,) if squeeze else (P, R)
    acc = tuple(_map_coord(lambda c: c.reshape(lead + c.shape[1:]), x) for x in acc)
    mark(prefix + "finish")
    return acc


# ---------------------------------------------------------------------------
# host-side finish: projective limb planes -> host affine point
# ---------------------------------------------------------------------------


def projective_to_host(curve, P):
    """Projective coords (..., n, 1) on the host -> affine point or None.

    The single modular inverse runs in host bignum arithmetic."""
    X, Y, Z = (_squeeze_last(c) for c in (P[0], P[1], P[2]))
    return _proj_host(curve, X, Y, Z)


def _squeeze_last(c):
    if isinstance(c, tuple):
        return tuple(_squeeze_last(ci) for ci in c)
    return np.asarray(c)[..., 0]


def _row(c, i: int):
    """Select row i of a leading batch axis (tuple-of-coords aware)."""
    if isinstance(c, tuple):
        return tuple(_row(ci, i) for ci in c)
    return c[i]


def _limbs_to_int(a) -> int:
    return sum(int(x) << (LIMB_BITS * i) for i, x in enumerate(np.asarray(a)))


def _proj_host(curve, X, Y, Z):
    field = curve.field
    if isinstance(X, tuple):  # Fp2
        f2 = curve.field
        fq = f2.base
        pq = fq.p
        rinv = pow(1 << (LIMB_BITS * X[0].shape[-1]), -1, pq)

        def dec2(c):
            return f2(
                fq(_limbs_to_int(c[0]) * rinv % pq),
                fq(_limbs_to_int(c[1]) * rinv % pq),
            )

        x, y, z = dec2(X), dec2(Y), dec2(Z)
        if z == f2.zero():
            return None
        zi = z.inv()
        return (x * zi, y * zi)

    pq = field.p
    rinv = pow(1 << (LIMB_BITS * X.shape[-1]), -1, pq)
    xv = _limbs_to_int(X) * rinv % pq
    yv = _limbs_to_int(Y) * rinv % pq
    zv = _limbs_to_int(Z) * rinv % pq
    if zv == 0:
        return None
    zi = pow(zv, -1, pq)
    return (field(xv * zi % pq), field(yv * zi % pq))
