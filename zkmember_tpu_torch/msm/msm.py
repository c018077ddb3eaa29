"""Classified variable-base MSM on batch-major point rows (counterpart of zkmember_tpu.msm.msm).

The v1 prover's MSM.  Scalars are classified on the host: zeros are
dropped, 0/1 scalars go through one masked tree reduction per tile, and the
rest through the sort + prefix-scan Pippenger with 8-bit windows; each
tile of `tile()` rows gives one projective partial sum, and the partials are
combined by a fixed-width tree reduction and one affine normalisation.
Every point operation is the complete projective a = 0 law of
``curves.device`` over the batch-major field vtables of ``fields.device``,
so every field product is a launch of kernel K3 on the card.

Points live on the device as affine Montgomery rows ``(B, n)`` (pairs of
them for Fp2 coordinates); results return as host affine points.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F_

from zkmember_tpu_torch.curves import device as cdv
from zkmember_tpu_torch.fields import device as dv
from zkmember_tpu_torch.fields.spec import FieldSpec, Fp2Spec

COMBINE_WIDTH = 32  # fixed batch of the partial-combine/finish step
WINDOW_BITS = 4  # fixed-base (setup) windows
PIPPENGER_C = 8  # window width of the sort + prefix-scan Pippenger


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def tile(device) -> int:
    """Point rows per MSM / fixed-base step: 16,384 on the card, 64 on the
    CPU (the reference's TPU and CPU tiles)."""
    return 16384 if torch.device(device).type == "cuda" else 64


def _to_device(c, device):
    """A (k, n) coordinate -- host uint32 numpy or a tensor -- as int32 on
    `device` (tuple aware)."""
    if isinstance(c, tuple):
        return tuple(_to_device(ci, device) for ci in c)
    if isinstance(c, torch.Tensor):
        return c.to(device=device, dtype=torch.int32)
    return torch.as_tensor(np.asarray(c).astype(np.int64), dtype=torch.int32, device=device)


class PointArray:
    """A device array of affine points: Fp coordinates are (B, n) rows, Fp2
    coordinates (c0, c1) pairs of them.  `curve` is the host curve."""

    def __init__(self, F, curve, x, y):
        self.F = F
        self.curve = curve
        self.x = x
        self.y = y

    @classmethod
    def from_planes(cls, F, curve, planes) -> "PointArray":
        """From a proving key's ``groth16.PointPlanes`` (host or device) onto
        F's device."""
        return cls(F, curve, _to_device(planes.x, F.device), _to_device(planes.y, F.device))

    def __len__(self):
        return cdv._leading0(self.x)

    def take(self, idx: np.ndarray) -> "PointArray":
        i = torch.as_tensor(np.asarray(idx, np.int64), device=self.F.device)
        return PointArray(self.F, self.curve, cdv.gather_coord(self.x, i),
                          cdv.gather_coord(self.y, i))

    def rows(self, s: int, e: int) -> "PointArray":
        return PointArray(self.F, self.curve, cdv._map(lambda c: c[s:e], self.x),
                          cdv._map(lambda c: c[s:e], self.y))

    def pad_to(self, m: int) -> "PointArray":
        """Zero rows up to m; callers mask them (bool) or give them digit 0."""
        b = len(self)
        if b == m:
            return self
        pad = lambda c: F_.pad(c, (0, 0, 0, m - b))  # noqa: E731
        return PointArray(self.F, self.curve, cdv._map(pad, self.x), cdv._map(pad, self.y))


def g1_points_from_host(spec: FieldSpec, curve, pts, device) -> PointArray:
    """Host affine points (no infinities) -> device PointArray."""
    F = dv.FpOps(spec, device)
    xs = spec.to_mont_host([p[0].v for p in pts])
    ys = spec.to_mont_host([p[1].v for p in pts])
    return PointArray(F, curve, _to_device(xs, F.device), _to_device(ys, F.device))


def g2_points_from_host(spec2: Fp2Spec, curve, pts, device) -> PointArray:
    F = dv.Fp2Ops(spec2, device)
    base = spec2.base

    def comp(i, j):
        return _to_device(base.to_mont_host([p[i].coeffs[j].v for p in pts]), F.device)

    return PointArray(F, curve, (comp(0, 0), comp(0, 1)), (comp(1, 0), comp(1, 1)))


# ---------------------------------------------------------------------------
# digits (host)
# ---------------------------------------------------------------------------


def u64_rows_to_digits(rows: np.ndarray, nbits: int) -> np.ndarray:
    """(B, nl) little-endian u64 scalar rows -> (B, nwin) 4-bit window
    digits, most-significant window first."""
    rows = np.ascontiguousarray(rows, "<u8")
    b8 = rows.view(np.uint8)  # (B, nl*8) LE bytes
    nib = np.empty((rows.shape[0], b8.shape[1] * 2), np.uint8)
    nib[:, 0::2] = b8 & 0xF
    nib[:, 1::2] = b8 >> 4
    nwin = (nbits + WINDOW_BITS - 1) // WINDOW_BITS
    if nwin > nib.shape[1]:
        raise ValueError("scalar rows are narrower than nbits")
    return nib[:, nwin - 1 :: -1].astype(np.int64)  # MSW first


def u64_rows_to_bytes(rows: np.ndarray, nbits: int) -> np.ndarray:
    """(B, nl) little-endian u64 scalar rows -> (B, nwin) 8-bit window
    digits, most-significant window first (the Pippenger's input)."""
    rows = np.ascontiguousarray(rows, "<u8")
    b8 = rows.view(np.uint8)
    nwin = (nbits + PIPPENGER_C - 1) // PIPPENGER_C
    if nwin > b8.shape[1]:
        raise ValueError("scalar rows are narrower than nbits")
    return b8[:, nwin - 1 :: -1].astype(np.int64)


def scalars_to_digits_np(scalars, nbits: int) -> np.ndarray:
    """(B, ceil(nbits/4)) 4-bit window digits, most-significant window first."""
    from zkmember_tpu_torch import native as zknative

    nwin = (nbits + WINDOW_BITS - 1) // WINDOW_BITS
    nl = (nwin * WINDOW_BITS + 63) // 64
    return u64_rows_to_digits(zknative.ints_to_u64(scalars, nl), nbits)


def scalars_to_bits_np(scalars, nbits: int) -> np.ndarray:
    """(B, nbits) uint32 0/1 rows, most significant bit first (the Jacobian
    MSM's input, ``parallel.dist.sharded_msm``)."""
    out = np.zeros((len(scalars), nbits), dtype=np.uint32)
    for i, s in enumerate(scalars):
        s = int(s)
        for j in range(nbits):
            out[i, j] = (s >> (nbits - 1 - j)) & 1
    return out


def sw_ops_for_curve(F, curve) -> cdv.SWOps:
    """The complete-formula ops bundle of a host SW curve over the vtable F."""
    return cdv.SWOps(F, cdv.b3_of(curve), f"{curve.name}/bm")


# ---------------------------------------------------------------------------
# tile steps: one tile of points -> one projective partial sum
# ---------------------------------------------------------------------------


def _bool_partial(ops, mask, X, Y):
    """0/1-scalar tile -> ONE projective partial sum (masked tree reduce)."""
    return cdv.swp_msm_bool(ops, mask, cdv.swp_from_affine(ops, X, Y))


def _interleave_ax1(a, b):
    """Pairwise interleave along axis 1: a -> even slots, b -> odd slots."""
    return cdv._map2(lambda x, y: torch.stack([x, y], dim=2).flatten(1, 2), a, b)


def _blelloch_inclusive_ax1(ops, P):
    """Work-efficient (Blelloch) inclusive prefix sums along axis 1 of
    (W, B) points, B a power of two: the up-sweep halves the width with
    pair sums (B - 1 adds), the down-sweep sets inclusive[2k+1] =
    pairs[k] and inclusive[2k] = pairs[k-1] + even[k] (B - 1 adds)."""
    W = cdv._leading0(P[0])
    evens = []
    cur = P
    while _width(cur) > 1:
        e = tuple(cdv._map(lambda c: c[:, 0::2], c) for c in cur)
        o = tuple(cdv._map(lambda c: c[:, 1::2], c) for c in cur)
        evens.append(e)
        cur = cdv.swp_add(ops, e, o)
    incl = cur  # (W, 1): the single total
    ident1 = cdv.swp_identity(ops, (W, 1))
    for e in reversed(evens):
        shifted = tuple(cdv._map2(lambda i, c: torch.cat([i, c[:, :-1]], 1), i, c)
                        for i, c in zip(ident1, incl))
        incl = tuple(_interleave_ax1(a, b) for a, b in zip(cdv.swp_add(ops, shifted, e), incl))
    return incl


def _width(P):
    """Width of axis 1 of a point's coordinates."""
    c = P[0]
    while isinstance(c, tuple):
        c = c[0]
    return c.shape[1]


def _tree_reduce_ax1(ops, P):
    """Sum (W, L) points along axis 1 (L a power of two) -> (W,) points."""
    while _width(P) > 1:
        e = tuple(cdv._map(lambda c: c[:, 0::2], c) for c in P)
        o = tuple(cdv._map(lambda c: c[:, 1::2], c) for c in P)
        P = cdv.swp_add(ops, e, o)
    return tuple(cdv._map(lambda c: c[:, 0], c) for c in P)


def _pippenger_partial(ops, digits, X, Y):
    """Sort + prefix-scan Pippenger: (B, W) 8-bit digits, MSW first -> ONE
    projective partial sum, every window at once on a (W, B) grid:
      1. per-window descending stable sort of the digits, and the point rows
         gathered onto the grid;
      2. Blelloch inclusive prefix sums S along each window;
      3. window sum = sum_i d_i P_i = sum_{v=1..2^c} S[c_v - 1] with
         c_v = #{i : d_i >= v}: a searchsorted, one gather, one 2^c-wide
         tree reduction (no scatter);
      4. the windows join by Horner on one running point (c doublings each,
         most significant first)."""
    F = ops.F
    B = digits.shape[0]
    nbuckets = 1 << PIPPENGER_C
    digs = digits.T  # (W, B)
    W = digs.shape[0]
    order = torch.argsort(-digs, dim=-1, stable=True)
    d_s = torch.gather(digs, -1, order)
    flat = order.reshape(-1)
    grid = lambda c: c[flat].reshape((W, B) + c.shape[1:])  # noqa: E731
    P = (cdv._map(grid, X), cdv._map(grid, Y), F.ones((W, B)))
    S = _blelloch_inclusive_ax1(ops, P)
    S_ext = tuple(cdv._map2(lambda i, s: torch.cat([i, s], 1), i, s)
                  for i, s in zip(cdv.swp_identity(ops, (W, 1)), S))  # (W, B + 1)
    thresholds = torch.arange(1, nbuckets + 1, device=digs.device).expand(W, nbuckets)
    c_v = B - torch.searchsorted(d_s.flip(-1).contiguous(), thresholds.contiguous())
    T = tuple(cdv._map(lambda c: c[torch.arange(W, device=c.device)[:, None], c_v], s)
              for s in S_ext)  # (W, 2^c)
    wsums = _tree_reduce_ax1(ops, T)
    acc = cdv.swp_identity(ops, ())
    for w in range(W):
        for _ in range(PIPPENGER_C):
            acc = cdv.swp_double(ops, acc)
        acc = cdv.swp_add(ops, acc, tuple(cdv._map(lambda c: c[w], x) for x in wsums))
    return acc


def _stack_pad_point(ops, partials):
    """Stack single-point partials to (COMBINE_WIDTH, ...); pad slots hold
    the projective identity (0, 1, 0), which the complete law absorbs."""
    rows = list(partials) + [cdv.swp_identity(ops, ())] * (COMBINE_WIDTH - len(partials))

    def stack(*cs):
        if isinstance(cs[0], tuple):
            return tuple(stack(*parts) for parts in zip(*cs))
        return torch.stack(cs)

    return tuple(stack(*(p[i] for p in rows)) for i in range(3))


def combine_partials(ops, partials):
    """Single-point projective partials -> one affine (x, y, is_identity),
    by fixed-width tree reductions (hierarchical above COMBINE_WIDTH) and
    one affine normalisation."""
    while len(partials) > COMBINE_WIDTH:
        partials = [cdv.swp_tree_reduce(ops, _stack_pad_point(ops, partials[i : i + COMBINE_WIDTH]))
                    for i in range(0, len(partials), COMBINE_WIDTH)]
    total = cdv.swp_tree_reduce(ops, _stack_pad_point(ops, partials))
    return cdv.swp_to_affine(ops, tuple(cdv._map(lambda c: c[None], c) for c in total))


def _chunks(n: int, m: int):
    for s in range(0, n, m):
        yield s, min(s + m, n)


def msm_device(points: PointArray, scalars, order: int, nbits: int | None = None):
    """sum_i scalars[i] * points[i] -> one affine device point (x, y, inf),
    or None when every scalar is zero.  Each class is cut into chunks of
    `tile()` rows; a chunk is padded to the next power of two (the
    reference pads to the whole tile, for one compiled shape).

    scalars: python ints (mod `order`) or a (B, nl) little-endian u64 array of
    canonical scalars (the prover's native path)."""
    if nbits is None:
        nbits = order.bit_length()
    nl = (nbits + 63) // 64
    if isinstance(scalars, np.ndarray) and scalars.dtype == np.uint64:
        rows = np.ascontiguousarray(scalars, "<u8")
    else:
        from zkmember_tpu_torch import native as zknative

        rows = zknative.ints_to_u64([int(s) % order for s in scalars], nl)
    if rows.shape[0] != len(points):
        raise ValueError(f"{rows.shape[0]} scalars for {len(points)} points")

    is_zero = ~rows.any(axis=1)
    is_one = (rows[:, 0] == 1) & ~rows[:, 1:].any(axis=1)
    ones_idx = np.nonzero(is_one)[0]
    gen_idx = np.nonzero(~is_zero & ~is_one)[0]

    F = points.F
    dev = F.device
    ops = sw_ops_for_curve(F, points.curve)
    T = tile(dev)
    partials = []
    if ones_idx.size:
        sel = points.take(ones_idx)
        for s, e in _chunks(len(ones_idx), T):
            m = _next_pow2(e - s)
            chunk = sel.rows(s, e).pad_to(m)
            mask = torch.arange(m, device=dev) < e - s
            partials.append(_bool_partial(ops, mask, chunk.x, chunk.y))
    if gen_idx.size:
        all_digits = u64_rows_to_bytes(rows[gen_idx], nbits)
        sel = points.take(gen_idx)
        for s, e in _chunks(len(gen_idx), T):
            m = _next_pow2(e - s)
            chunk = sel.rows(s, e).pad_to(m)
            digits = np.zeros((m, all_digits.shape[1]), np.int64)
            digits[: e - s] = all_digits[s:e]
            partials.append(_pippenger_partial(
                ops, torch.as_tensor(digits, device=dev), chunk.x, chunk.y))
    if not partials:
        return None
    return combine_partials(ops, partials)


def msm(points: PointArray, scalars, order: int, nbits: int | None = None):
    """MSM -> host affine point (or None for the identity)."""
    out = msm_device(points, scalars, order, nbits)
    if out is None:
        return None
    return affine_result_to_host(points.F, points.curve, out)


def affine_result_to_host(F, curve, xyi):
    """Device single affine (x, y, inf) -> host affine point (or None)."""
    x, y, inf = xyi
    if bool(inf.reshape(-1)[0]):
        return None
    if isinstance(x, tuple):  # Fp2
        base = F.spec.base
        x0, x1 = (base.from_mont_host(c.cpu().numpy())[0] for c in x)
        y0, y1 = (base.from_mont_host(c.cpu().numpy())[0] for c in y)
        f2 = curve.field
        fq = f2.base
        return (f2(fq(x0), fq(x1)), f2(fq(y0), fq(y1)))
    xv = F.spec.from_mont_host(x.cpu().numpy())[0]
    yv = F.spec.from_mont_host(y.cpu().numpy())[0]
    return (curve.field(xv), curve.field(yv))
