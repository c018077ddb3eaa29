"""KZG10 polynomial commitments, Marlin flavour (counterpart of zkmember_tpu.snark.kzg).

Degree bounds and batched openings as ark-poly-commit's MarlinKZG10 gives
the reference's Marlin.  Host/device split:

  device  the SRS powers beta^i G1 by fixed-base multiplication (setup,
          kernel K3), their Straus tables (built once, products on K2),
          and every commitment and opening proof as one Straus MSM over
          the tables: K1, then the finish
  host    the witness polynomial's synthetic division and the pairing
          checks (O(N) bignum / O(1) pairings)

Two routes, chosen by the SRS's lane budget ``max_tab_lanes`` (by
default the powers whose table fits ``straus.table_budget`` of the SRS's
device; the reference reads 2^19 from ``ZKMEMBER_TAB_LANES``):

  table    D + 1 within the budget: the SRS table has R = ceil((D + 1) / w)
           rows of w lanes on K1's row axis, power i at row i // w, lane
           i % w.  A commitment of n coefficients at offset o puts its
           scalars at lanes [o, o + n) and zero digits elsewhere (entry 0,
           the identity); a batch launches K1 once over the rows its
           commitments touch and the finish once over them, and the row
           sums are added on the host.
  on the fly  past the budget no table is built: each commitment runs
           ``straus.msm_program`` over its powers in slices of MSM_CHUNK
           lanes (the reference's ``_MSM_CHUNK``), each slice building its
           own transient table, and the slices' points are added on the
           host.

The reference takes its table route only on a TPU, in 2^14-lane chunks;
the port takes it on every device within the budget.  Commitments are
compared as points.

Degree bounds use shifted powers: a commitment to p with bound d also
carries a commitment to x^(D-d) p(x) under the top SRS powers, and the
verifier checks the two openings agree (``check_degree_bound``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from zkmember_tpu_torch import device as devmod
from zkmember_tpu_torch import native as zknative
from zkmember_tpu_torch.msm import straus
from zkmember_tpu_torch.snark import groth16, prove_lm
from zkmember_tpu_torch.snark.groth16 import pairing_config
from zkmember_tpu_torch.utils import rng as frng

MAX_LANES = 1 << 14  # lanes of one SRS table row
MSM_CHUNK = 1 << 18  # lanes of one on-the-fly MSM past the budget


@dataclass
class UniversalParams:
    curve: str
    max_degree: int
    powers: "groth16.PointPlanes"  # beta^i G1, i in [0, D]: (D + 1, n) Montgomery rows
    h: tuple  # G2
    beta_h: tuple  # beta G2
    g: tuple  # G1 generator
    max_tab_lanes: int  # the table route while D + 1 fits it
    table: tuple | None = None  # (w, K1 records of the SRS in rows of w lanes), once built

    @property
    def device(self) -> torch.device:
        return self.powers.x.device


@dataclass
class Commitment:
    c: tuple  # G1 affine host point
    shifted: tuple | None = None  # commitment to x^(D-d) p(x), if bounded
    degree_bound: int | None = None


@dataclass
class OpeningProof:
    w: tuple  # G1 affine witness commitment


def setup(max_degree: int, curve: str = "bls12_381", rng=None, device=None,
          max_tab_lanes: int | None = None) -> UniversalParams:
    """Universal SRS: powers of a fresh beta in G1 (device fixed-base
    multiplication, K3 on the card) and (h, beta h) in G2.  rng defaults to
    OS entropy; tests and the harness pass utils.rng.test_rng().
    max_tab_lanes: the lane budget of the SRS table (module docstring);
    None gives the lanes whose table fits the device's table budget."""
    cfg = pairing_config(curve)
    rng = rng or frng.secure_rng()
    dev = devmod.resolve(device)
    r = cfg.r
    mod = cfg.mod
    beta = frng.nonzero_field_element(rng, r)
    pows = [1] * (max_degree + 1)
    for i in range(1, max_degree + 1):
        pows[i] = pows[i - 1] * beta % r
    x, y, inf = groth16._fixed_base_mul_device(cfg, cfg.F1(dev), mod.G1_GEN, mod.G1, pows)
    if inf.any():
        raise ValueError("an SRS power is the identity")
    if max_tab_lanes is None:
        ops = prove_lm.sw_ops(cfg, False, dev)
        max_tab_lanes = straus.table_budget(dev) // straus.table_bytes(ops, 1, 1)
    return UniversalParams(
        curve=curve,
        max_degree=max_degree,
        powers=groth16.PointPlanes(x, y),
        h=mod.G2_GEN,
        beta_h=mod.G2.mul(beta, mod.G2_GEN),
        g=mod.G1_GEN,
        max_tab_lanes=max_tab_lanes,
    )


def uses_table(pp: UniversalParams) -> bool:
    """Whether commitments under `pp` take the table route."""
    return pp.max_degree + 1 <= pp.max_tab_lanes


def table_lanes(max_degree: int) -> int:
    """The lanes w of one SRS table row: the powers' count rounded up to a
    power of two, at least the kernel's 64 lanes, at most MAX_LANES."""
    return min(MAX_LANES, max(prove_lm.MIN_LANES, prove_lm._next_pow2(max_degree + 1)))


def _powers_tab(pp: UniversalParams, lanes: int):
    """K1 records (16, R, w, 3 n/2) of the SRS powers as R rows of w =
    `lanes` lanes, kept in ``pp.table`` until a call asks for another w;
    lanes past D are zero points, never selected (their scalars are zero)."""
    if pp.table is None or pp.table[0] != lanes:
        cfg = pairing_config(pp.curve)
        D1 = pp.max_degree + 1
        R = -(-D1 // lanes)

        def rows(c):  # (D + 1, n) -> (R, n, w)
            c = torch.nn.functional.pad(c, (0, 0, 0, R * lanes - D1))
            return c.reshape(R, lanes, -1).transpose(1, 2).contiguous()

        ops = prove_lm.sw_ops(cfg, False, pp.device)
        pp.table = (lanes, straus.table_program(ops, rows(pp.powers.x), rows(pp.powers.y)))
    return pp.table[1]


def _msm_powers_many(pp: UniversalParams, items, lanes: int | None = None) -> list:
    """[sum_i coeffs[i] beta^(offset + i) G for (coeffs, offset) in items] as
    host affine points (None for the identity).  coeffs: list[int] or
    (n, nl) u64 Montgomery rows (the native rows of Marlin's openings).

    Table route: each item's scalars take the table rows of w = `lanes`
    lanes (default ``table_lanes(D)``; tests pass fewer to force several
    rows) that [offset, offset + n) touches; those rows of every item stand
    side by side on K1's row axis (the table rows gathered to match), so
    the batch is ONE K1 launch and ONE finish; each item's row sums are
    added on the host.  On-the-fly route (past ``pp.max_tab_lanes``):
    ``_msm_powers_otf`` in slices of MSM_CHUNK lanes (`lanes` is the
    table route's)."""
    cfg = pairing_config(pp.curve)
    fr = cfg.fr_spec
    nl = (fr.n + 3) // 4
    planes, offsets = [], []
    for coeffs, offset in items:
        if isinstance(coeffs, np.ndarray):
            rows = zknative.NativeField.get(fr.p, fr.n).from_mont(coeffs)  # canonical u64
        else:
            rows = zknative.ints_to_u64([int(c) % cfg.r for c in coeffs], nl)
        n = rows.shape[0]
        if offset < 0 or offset + n > pp.max_degree + 1:
            raise ValueError(f"{n} coefficients at offset {offset} exceed the SRS degree "
                             f"{pp.max_degree}")
        planes.append(zknative.u64_to_u16_planes(rows)[:, : fr.n])  # (n, n16)
        offsets.append(offset)
    if not uses_table(pp):
        return _msm_powers_otf(pp, planes, offsets)
    w = lanes or table_lanes(pp.max_degree)
    zs, row_ids, spans = [], [], []
    for z16, offset in zip(planes, offsets):
        n = z16.shape[0]
        if n == 0:
            spans.append((len(row_ids), len(row_ids)))
            continue
        r0, r1 = offset // w, (offset + n - 1) // w + 1
        z = np.zeros(((r1 - r0) * w, fr.n), np.int32)
        start = offset - r0 * w
        z[start : start + n] = z16
        zs.append(z.reshape(r1 - r0, w, fr.n))
        spans.append((len(row_ids), len(row_ids) + r1 - r0))
        row_ids.extend(range(r0, r1))
    if not row_ids:
        return [None] * len(spans)
    tab = _powers_tab(pp, w)
    if row_ids != list(range(tab.shape[1])):
        tab = tab[:, row_ids].contiguous()  # (16, rows, w, 3 n/2)
    z = np.concatenate(zs).transpose(0, 2, 1)  # (rows, n, w)
    ops = prove_lm.sw_ops(cfg, False, pp.device)
    nwin = (cfg.r.bit_length() + straus.WINDOW_BITS - 1) // straus.WINDOW_BITS
    acc = straus.msm_precomp_program(ops, tab, nwin,
                                     torch.as_tensor(np.ascontiguousarray(z), device=pp.device))
    X, Y, Z = torch.stack(acc).cpu().numpy()  # one device -> host copy
    return _host_sums(cfg.mod.G1, X, Y, Z, spans)


def _host_sums(curve, X, Y, Z, spans) -> list:
    """Each span [a, b) of projective rows (X, Y, Z) (rows, n, 1) summed on
    the host as one affine point (None for the identity)."""
    out = []
    for a, b in spans:
        total = None
        for i in range(a, b):
            total = curve.add(total, straus.projective_to_host(curve, (X[i], Y[i], Z[i])))
        out.append(total)
    return out


def _msm_powers_otf(pp: UniversalParams, planes, offsets) -> list:
    """The on-the-fly route: item k's scalars planes[k] (n, n16) against
    powers [offsets[k], offsets[k] + n), in slices of at most MSM_CHUNK lanes,
    each slice padded to a power of two of at least the kernel's 64 lanes
    (zero scalars select the identity) and run through
    ``straus.msm_program``, which builds and drops its own table.  One
    device -> host copy for every slice; the slices' points are added on
    the host."""
    cfg = pairing_config(pp.curve)
    fr = cfg.fr_spec
    ops = prove_lm.sw_ops(cfg, False, pp.device)
    nwin = (cfg.r.bit_length() + straus.WINDOW_BITS - 1) // straus.WINDOW_BITS
    pad = torch.nn.functional.pad
    outs, spans = [], []
    for z16, offset in zip(planes, offsets):
        first = len(outs)
        for s in range(0, z16.shape[0], MSM_CHUNK):
            e = min(s + MSM_CHUNK, z16.shape[0])
            width = max(prove_lm.MIN_LANES, prove_lm._next_pow2(e - s))
            X, Y = (pad(c[offset + s : offset + e].T, (0, width - (e - s)))
                    for c in (pp.powers.x, pp.powers.y))  # (n, width)
            z = np.zeros((fr.n, width), np.int32)
            z[:, : e - s] = z16[s:e].T
            outs.append(straus.msm_program(ops, X, Y, torch.as_tensor(z, device=pp.device), nwin))
        spans.append((first, len(outs)))
    if not outs:
        return [None] * len(spans)
    X, Y, Z = torch.stack([torch.stack(P) for P in outs], 1).cpu().numpy()  # one copy
    return _host_sums(cfg.mod.G1, X, Y, Z, spans)


def _msm_powers(pp: UniversalParams, coeffs, offset: int = 0):
    """sum_i coeffs[i] beta^(offset + i) G: ``_msm_powers_many`` of one."""
    return _msm_powers_many(pp, [(coeffs, offset)])[0]


def commit_many(pp: UniversalParams, polys, lanes: int | None = None) -> list[Commitment]:
    """Commitments to [(coeffs, degree_bound or None), ...]: every MSM of
    the batch (the shifted ones of bounded polynomials too) in one
    ``_msm_powers_many`` over table rows of `lanes`."""
    items = []
    for coeffs, bound in polys:
        items.append((coeffs, 0))
        if bound is not None:
            if len(coeffs) - 1 > bound:
                raise ValueError(f"degree {len(coeffs) - 1} exceeds the bound {bound}")
            items.append((coeffs, pp.max_degree - bound))
    pts = _msm_powers_many(pp, items, lanes)
    out, k = [], 0
    for coeffs, bound in polys:
        shifted = pts[k + 1] if bound is not None else None
        out.append(Commitment(c=pts[k], shifted=shifted, degree_bound=bound))
        k += 2 if bound is not None else 1
    return out


def commit(pp: UniversalParams, coeffs: list[int], degree_bound: int | None = None) -> Commitment:
    """Commit to p (coefficient list, low -> high); optional degree bound."""
    return commit_many(pp, [(coeffs, degree_bound)])[0]


def poly_eval(coeffs: list[int], z: int, p: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * z + c) % p
    return acc


def _synthetic_division(coeffs: list[int], z: int, p: int) -> list[int]:
    """q(x) = (p(x) - p(z)) / (x - z), degree deg(p) - 1 (host O(N))."""
    n = len(coeffs)
    q = [0] * (n - 1)
    acc = 0
    for i in range(n - 1, 0, -1):
        acc = (acc * z + coeffs[i]) % p
        q[i - 1] = acc
    return q


def open_at(pp: UniversalParams, coeffs: list[int], z: int) -> tuple[int, OpeningProof]:
    """Evaluation v = p(z) and the KZG witness commitment W = [q(beta)]G."""
    r = pairing_config(pp.curve).r
    v = poly_eval(coeffs, z, r)
    q = _synthetic_division(coeffs, z, r)
    w = _msm_powers(pp, q) if q else None
    return v, OpeningProof(w=w)


def _pairing_check(pp: UniversalParams, lhs_pt, w, z: int) -> bool:
    """e(lhs, H) == e(W, beta H - z H), two host pairings."""
    cfg = pairing_config(pp.curve)
    mod = cfg.mod
    g2 = mod.G2
    if w is None:
        return lhs_pt is None
    rhs_g2 = g2.add(pp.beta_h, g2.neg(g2.mul(z % cfg.r, pp.h)))
    one = mod.multi_pairing([(lhs_pt, pp.h), (mod.G1.neg(w), rhs_g2)])
    return one == type(one).one()


def check(pp: UniversalParams, comm: Commitment, z: int, v: int, proof: OpeningProof) -> bool:
    """e(C - vG, H) == e(W, beta H - z H)  (host pairings)."""
    cfg = pairing_config(pp.curve)
    g1 = cfg.mod.G1
    lhs_pt = g1.add(comm.c, g1.neg(g1.mul(v % cfg.r, pp.g)))
    return _pairing_check(pp, lhs_pt, proof.w, z)


def check_degree_bound(
    pp: UniversalParams, comm: Commitment, z: int, v: int, v_shifted: int
) -> bool:
    """Degree-bound check at an opened point: with deg(p) <= d the shifted
    polynomial is X^(D-d) p, so its value at z is v z^(D-d).  Callers also
    verify both openings at the same point (``snark.marlin.verify`` does
    for g_1 and g_2)."""
    if comm.shifted is None or comm.degree_bound is None:
        return False
    r = pairing_config(pp.curve).r
    return v_shifted % r == v * pow(z % r, pp.max_degree - comm.degree_bound, r) % r


def batch_check_same_point(
    pp: UniversalParams, comms: list[Commitment], z: int, vals: list[int],
    proofs: list[OpeningProof], xi: int,
) -> bool:
    """Combine openings at one point with powers of challenge xi, 2 pairings."""
    cfg = pairing_config(pp.curve)
    g1 = cfg.mod.G1
    r = cfg.r
    acc_c, acc_w, acc_v, x = None, None, 0, 1
    for comm, v, prf in zip(comms, vals, proofs):
        acc_c = g1.add(acc_c, g1.mul(x, comm.c))
        if prf.w is not None:
            acc_w = g1.add(acc_w, g1.mul(x, prf.w))
        acc_v = (acc_v + x * v) % r
        x = x * xi % r
    lhs_pt = g1.add(acc_c, g1.neg(g1.mul(acc_v, pp.g)))
    return _pairing_check(pp, lhs_pt, acc_w, z)
