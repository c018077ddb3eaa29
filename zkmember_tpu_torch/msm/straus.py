"""Straus MSM on limb-major point planes (counterpart of zkmember_tpu.msm.straus).

    sum_i s_i P_i  =  sum_w 16^w ( sum_i T_i[d_{i,w}] )

with T_i = [0..15] P_i the per-point table (``table_program``, in K1's
packed layout) and d_{i,w} the w-th 4-bit digit of s_i.  Kernel K1
(``select_reduce_cuda``) selects and reduces each lane tile per window;
the finish (``finish_cuda``: tail reduction and Horner join, one kernel
on the card) adds up K1's lanes and folds the window sums.
``tree_reduce_lanes`` and ``horner_join`` keep the reference's order for
the lane reductions outside K1 (``window_sums``, ``bool_msm_program``).
Zero scalars select entry 0, the identity, so padded lanes vanish.

Two routes share that machinery:
  - precomputed: the table is built once per proving key and kept
    (``msm_precomp_program`` / ``msm_precomp_batch``);
  - on the fly: each call builds the table of its own lanes and drops it
    on return (``window_sums``, ``msm_program``, ``msm_program_chunked``),
    for keys and SRSs whose tables would not fit the table budget
    (``table_budget``).
Boolean scalars skip the windows: one masked select and one lane
reduction (``bool_msm_program``).

Over a mesh (``parallel.dist``), ``sharded_msm_program`` and
``sharded_bool_msm_program`` split the lanes over the "msm" axis: a local
half on each rank's lane block (``sharded_window_sums``: K1 over the
block of the kept table, or of a table built on the fly; or the boolean
reduction), one packed all-gather of its output lanes, and a combine over
the gathered lanes (``combine_window_sums``: the finish; the boolean
class's lane reduction) that every rank runs.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from zkmember_tpu_torch.curves import device as cdv
from zkmember_tpu_torch.fields.spec import LIMB_BITS
from zkmember_tpu_torch.msm import finish_cuda, select_reduce_cuda

WINDOW_BITS = 4
TABLE = 1 << WINDOW_BITS
TAIL_WIDTH = 256  # contiguous halving above this width, even/odd rounds below
SHARD_MIN_LANES = 64  # K1's smallest whole tiles (select_reduce_cuda.tile_shape)


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
    records (16, R, B, 3 C n/2) (``select_reduce_cuda.pack_records``).  It
    depends only on the points: a proving key's is built once; the
    on-the-fly route builds one per call."""
    return select_reduce_cuda.pack_records(small_table(ops, cdv.swp_from_affine(ops, X, Y)))


def table_bytes(ops, R: int, B: int) -> int:
    """Bytes of ``table_program``'s records for R rows of B lanes: 16
    entries of 3 projective coordinates, two 16-bit limbs a word."""
    fp2 = isinstance(ops.b3, tuple)
    n = (ops.F.spec.base if fp2 else ops.F.spec).n
    return TABLE * R * B * 3 * (2 if fp2 else 1) * n * 2


def table_budget(device) -> int:
    """Bytes of Straus tables that a proving key or an SRS keeps on
    `device`: an eighth of its memory (the card's; the host's for the CPU).
    A table's build holds its 16 unpacked entries, their stack and the
    packed records at once: its peak is about 5.4 times the table (the
    depth-32 G1 table on an H100, ``chip_smoke.py``'s scale phase), so
    building the largest table the budget allows takes about two thirds
    of the device and leaves room for a proof's working set.  Past the
    budget, MSMs take the on-the-fly route."""
    device = torch.device(device)
    if device.type == "cuda":
        total = torch.cuda.get_device_properties(device).total_memory
    else:
        total = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    return total // 8


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


def window_sums(ops, X, Y, z, nwin: int):
    """Per-window sums of the MSM of affine points (X, Y) ([R,] n, B) with
    canonical scalar limbs z ([R,] nl, B): coords (W, [R,] n, 1), most
    significant window first.  The lane-parallel half of the on-the-fly
    MSM: this call's table (``table_program``), K1 over it, then each
    window's K1 tile sums reduced to one lane (``tree_reduce_lanes`` over
    K2).  The table is dropped on return."""
    digits = digits_from_limbs(z, nwin).contiguous()  # (W, [R,] B)
    squeeze = digits.ndim == 2  # no row axis: R = 1
    if squeeze:
        digits = digits[:, None]
    S = select_reduce_cuda.select_reduce(ops, table_program(ops, X, Y), digits)  # (W, R, n, NT)
    S = tree_reduce_lanes(ops, S)
    if squeeze:
        S = tuple(_map_coord(lambda c: c[:, 0], x) for x in S)
    return S


def msm_program(ops, X, Y, z, nwin: int, mark=None, prefix: str = ""):
    """On-the-fly MSM of affine points (X, Y) ([R,] n, B) with canonical
    scalar limbs z ([R,] nl, B): this call's table, then K1, then the
    finish; projective coords ([R,] n, 1), equal as points to
    ``horner_join(ops, window_sums(...))``.  Zero scalars (padded lanes,
    whatever their coordinates) select the identity.  mark/prefix as in
    ``msm_precomp_program``, with one more stage, prefix + "table".  (The
    reference's ``msm_kernel``; eager PyTorch has no separate jitted entry.)"""
    tab = table_program(ops, X, Y)
    if mark is not None:
        mark(prefix + "table")
    return msm_precomp_program(ops, tab, nwin, z, mark, prefix)


def msm_program_chunked(ops, X, Y, z, nwin: int, max_lanes: int = 1 << 18, mark=None,
                        prefix: str = ""):
    """``msm_program`` over slices of at most `max_lanes` lanes, the
    partial points added with one complete addition each: a call's
    transient table is 48 times its slice of point planes, so wide MSMs
    run slice by slice."""
    B = _lanes(X)
    if B <= max_lanes:
        return msm_program(ops, X, Y, z, nwin, mark, prefix)
    if B % max_lanes:
        raise ValueError(f"{B} lanes do not split into slices of {max_lanes}")
    acc = None
    for s in range(0, B, max_lanes):
        def sl(c):
            return _map_coord(lambda a: a[..., s : s + max_lanes], c)

        part = msm_program(ops, sl(X), sl(Y), sl(z), nwin, mark, prefix)
        acc = part if acc is None else cdv.swp_add(ops, acc, part)
    if mark is not None:
        mark(prefix + "chunk_add")
    return acc


def bool_msm_program(ops, X, Y, mask):
    """MSM with 0/1 scalars: affine points (X, Y) ([R,] n, B), mask ([R,] B)
    nonzero where the scalar is 1.  One masked select to the identity and
    one lane reduction (``tree_reduce_lanes``, B - 1 complete additions on
    K2): no table and no K1.  Returns projective coords ([R,] n, 1)."""
    P = cdv.swp_from_affine(ops, X, Y)
    ident = cdv.swp_identity(ops, ops.F.batch_shape(X))
    return tree_reduce_lanes(ops, cdv.swp_select(ops, mask != 0, P, ident))


def msm_precomp_program(ops, tab, nwin: int, z, mark=None, prefix: str = ""):
    """MSM from a precomputed table through kernel K1, then the tail
    reduction and the Horner join (``finish_cuda``).  tab: table_program's
    records (16, R, B, 3 C n/2); z ([R,] nl, B) canonical scalar limbs.
    Returns projective coords ([R,] n, 1).  mark: optional phase clock
    (utils.obs.PhaseClock), called after each stage as mark(prefix + stage).
    One proof of ``msm_precomp_batch``."""
    acc = msm_precomp_batch(ops, tab, nwin, z[None], mark, prefix)
    return tuple(_map_coord(lambda c: c[0], x) for x in acc)


def msm_tile_sums(ops, tab, nwin: int, z):
    """K1 over a table: z (P, [R,] nl, B) canonical scalar limbs against
    table_program's records (16, R, B, 3 C n/2) -> per-thread window sums,
    coords (W, P, R, n, B / L), most significant window first."""
    digits = digits_from_limbs(z, nwin).contiguous()  # (W, P, [R,] B)
    if digits.ndim == 3:  # no row axis: R = 1
        digits = digits[:, :, None]
    return select_reduce_cuda.select_reduce(ops, tab, digits)


def msm_precomp_batch(ops, tab, nwin: int, z, mark=None, prefix: str = ""):
    """P MSMs against ONE precomputed table (the reference's proof-batch
    axis): z (P, [R,] nl, B) holds P proofs' scalars for the same key
    points.  K1 runs once over digits (W, P, [R,] B) (``msm_tile_sums``);
    the finish runs once over the P R rows of its window sums (a view).
    Returns projective coords with leading (P, [R]): (P, [R,] n, 1).
    mark/prefix as in ``msm_precomp_program``."""
    mark = mark or (lambda name: None)
    S = msm_tile_sums(ops, tab, nwin, z)  # (W, P, R, n, NT)
    mark(prefix + "select_reduce")
    W, P, R = _planes_shape(S)[:3]
    rows = tuple(_map_coord(lambda c: c.reshape((W, P * R) + c.shape[3:]), x) for x in S)
    acc = finish_cuda.msm_finish(ops, rows)  # (P R, n, 1)
    lead = (P,) if z.ndim == 3 else (P, R)
    acc = tuple(_map_coord(lambda c: c.reshape(lead + c.shape[1:]), x) for x in acc)
    mark(prefix + "finish")
    return acc


def _planes_shape(S):
    c = S[0]
    while isinstance(c, tuple):
        c = c[0]
    return tuple(c.shape)


# ---------------------------------------------------------------------------
# sharded MSMs: the lane axis split over the mesh axis "msm"
# ---------------------------------------------------------------------------


def _pow2_axis(mesh) -> int:
    D = mesh.shape["msm"]
    if D & (D - 1):
        raise ValueError(f"the combine needs a power-of-two msm axis, got {D}")
    return D


def _pad_lanes(c, B: int):
    return _map_coord(lambda a: torch.nn.functional.pad(a, (0, B - a.shape[-1])), c)


def sharded_window_sums(ops, tab, z, nwin: int):
    """The local half of ``sharded_msm_program`` on one rank's lane block:
    K1 over the block's table `tab` (16, R, b, 3 C n/2) (its block of a
    kept table, or ``table_program`` of its points) with scalar limbs z
    ([R,] nl, b), coords (W, [R,] n, b / L), K1's per-thread window sums,
    most significant window first.  A block narrower than K1's
    SHARD_MIN_LANES is padded with zero-scalar lanes on copies of lane 0,
    whose entry 0 is the identity."""
    b = tab.shape[2]
    if b < SHARD_MIN_LANES:
        pad = tab[:, :, :1].expand(-1, -1, SHARD_MIN_LANES - b, -1)
        tab, z = torch.cat([tab, pad], dim=2), _pad_lanes(z, SHARD_MIN_LANES)
    S = msm_tile_sums(ops, tab.contiguous(), nwin, z[None])  # (W, 1, R, n, NT)
    squeeze = z.ndim == 2  # no row axis: R = 1
    return tuple(_map_coord(lambda c: c[:, 0, 0] if squeeze else c[:, 0], x) for x in S)


def combine_window_sums(ops, S):
    """The combine of ``sharded_msm_program``: K1's window sums gathered
    from D ranks, coords (W, [R,] n, NT), NT a power of two -> the MSM,
    coords ([R,] n, 1): the finish (the tail over the NT lanes and the
    Horner join; the kernel on the card, its plain version on the CPU)."""
    NT = _lanes(S[0])
    if NT & (NT - 1):
        raise ValueError(f"the combine needs a power-of-two lane count, got {NT}")
    return finish_cuda.msm_finish(ops, S)


def _gather_lanes(P, group):
    """Coords (..., n, t) from each rank of group -> (..., n, D t), lanes
    d t .. (d + 1) t from group rank d (one packed all-gather)."""
    from zkmember_tpu_torch.parallel import dist

    G = dist.all_gather_points(P, group)  # (D, ..., n, t)
    return tuple(_map_coord(lambda c: c.movedim(0, -2).flatten(-2).contiguous(), x) for x in G)


def sharded_msm_program(ops, mesh, X, Y, z, nwin: int, tab=None, mark=None, prefix: str = ""):
    """MSM of affine points (X, Y) ([R,] n, B) with canonical scalar limbs z
    ([R,] nl, B), replicated, the lanes split over mesh axis "msm" (B
    divisible by the axis size D, a power of two): each rank's
    ``sharded_window_sums`` over its block, from its block of the kept
    table `tab` (``table_program``'s records of all B lanes) or, with no
    table, from its block's table built on the fly; one packed all-gather
    of K1's window sums; ``combine_window_sums`` over the gathered lanes.
    The single-device route plus one all-gather: blocks of whole K1 tiles
    gather to the single-device K1 output, limb for limb.  Returns
    projective coords ([R,] n, 1) on every rank.  mark/prefix as in
    ``msm_precomp_program``, with the stages table (on the fly),
    select_reduce, gather and finish."""
    from zkmember_tpu_torch.parallel import dist

    mark = mark or (lambda name: None)
    D, j = _pow2_axis(mesh), mesh.coords["msm"]
    zl = dist.block(z, D, j, -1)
    if tab is None:
        tab = table_program(ops, *(dist.block(c, D, j, -1) for c in (X, Y)))
        mark(prefix + "table")
    else:
        tab = dist.block(tab, D, j, 2)
    S = sharded_window_sums(ops, tab, zl, nwin)
    mark(prefix + "select_reduce")
    S = _gather_lanes(S, mesh.groups["msm"])
    mark(prefix + "gather")
    acc = combine_window_sums(ops, S)
    mark(prefix + "finish")
    return acc


def sharded_bool_msm_program(ops, mesh, X, Y, mask):
    """``bool_msm_program`` with the lanes split over mesh axis "msm": the
    masked lane reduction of each rank's block, one packed all-gather, and
    ``tree_reduce_lanes`` over the D gathered lanes (D a power of two).
    Returns projective coords ([R,] n, 1) on every rank."""
    from zkmember_tpu_torch.parallel import dist

    D, j = _pow2_axis(mesh), mesh.coords["msm"]
    Xl, Yl = (dist.block(c, D, j, -1) for c in (X, Y))
    S = bool_msm_program(ops, Xl, Yl, dist.block(mask, D, j, -1))
    return tree_reduce_lanes(ops, _gather_lanes(S, mesh.groups["msm"]))


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
