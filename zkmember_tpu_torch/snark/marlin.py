"""Marlin: universal setup, AHP indexer, prover, verifier (counterpart of zkmember_tpu.snark.marlin).

ark-marlin as the reference benches drive it: universal_setup(num_constraints,
num_vars, num_non_zero) -> index -> prove -> verify, including the
universal-SRS mode where one index at the largest size serves smaller
registrars padded with default members (the padding is the app's job,
``app.bench_harness``).  The AHP and its conventions are the reference's
(its module docstring); the same seeds give the same SRS, index and proof,
commitment for commitment, in both packages.

Host/device split:

  device  every transform of 2^11 points or more (``PolyEngine``: the
          limb-major NTT of ``ntt.lm``, products on K2), the SRS and its
          tables, every commitment and opening (``snark.kzg``: K3, K2, K1
          and the finish)
  host    O(N) bookkeeping on native Montgomery u64 rows
          (``native.NativeField``), the transcript, small transforms and
          the verifier's pairings

The native field library is required (the reference falls back to Python
bignums without it).  ``universal_setup``, ``index`` and ``prove`` run on
the card unless the caller passes ``device="cpu"``.

Zero knowledge: the witness polynomials (w_hat, z_A, z_B and hence z) get
uniformly random multiples of vanishing polynomials, and a committed
random mask polynomial m(X) with sum_H m = 0 is added into q_1 (the
ark-marlin mask_poly), so g_1 and h_1 are randomized too.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from zkmember_tpu_torch import device as devmod
from zkmember_tpu_torch import native as zknative
from zkmember_tpu_torch.fields import lm
from zkmember_tpu_torch.fields.spec import FieldSpec
from zkmember_tpu_torch.ntt import lm as nttlm
from zkmember_tpu_torch.r1cs.cs import ConstraintSystem
from zkmember_tpu_torch.snark import kzg
from zkmember_tpu_torch.snark.groth16 import pairing_config
from zkmember_tpu_torch.snark.transcript import Transcript
from zkmember_tpu_torch.utils import obs
from zkmember_tpu_torch.utils import poly as hp
from zkmember_tpu_torch.utils import rng as frng

MATRICES = ("A", "B", "C")


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


# ---------------------------------------------------------------------------
# polynomial transform engine: device NTT for big sizes, host for small
# ---------------------------------------------------------------------------


class PolyEngine:
    """NTTs over Montgomery u64 rows: the limb-major device NTT (K2 on the
    card) from DEVICE_THRESHOLD points up, the host radix-2 NTT below; the
    host <-> device conversions run through the native Montgomery layer."""

    DEVICE_THRESHOLD = 1 << 11

    def __init__(self, spec: FieldSpec, device):
        self.spec = spec
        self.p = spec.p
        self.device = torch.device(device)
        self.nf = zknative.NativeField.get(spec.p, spec.n)
        if self.nf is None:
            raise RuntimeError("Marlin needs the native field library (zkmember_tpu_torch.native)")

    def _w(self, size: int) -> int:
        return pow(self.spec.two_adic_root, (1 << self.spec.two_adicity) // size, self.p)

    # -- int list <-> Montgomery u64 rows (native) ---------------------------
    def to_rows(self, vals: list[int]) -> np.ndarray:
        return self.nf.to_mont(zknative.ints_to_u64(vals, self.nf.nl))

    def from_rows(self, rows: np.ndarray) -> list[int]:
        return self.nf.mont_to_ints(rows)

    def _device_fft(self, rows: np.ndarray, inverse: bool) -> np.ndarray:
        """(N, nl) Montgomery rows -> their (inverse) NTT on the device."""
        size = rows.shape[0]
        dlm = nttlm.DomainLM.get(self.spec, size, self.device)
        planes = zknative.u64_to_u16_planes(rows).T.astype(np.int32)  # (n, N)
        x = torch.as_tensor(np.ascontiguousarray(planes), device=self.device)
        out = nttlm.ntt(self.spec, x, dlm.tw_inv if inverse else dlm.tw_fwd, dlm.perm)
        if inverse:
            out = lm.mont_mul(self.spec, out, dlm.size_inv)
        return zknative.u16_planes_to_u64(out.cpu().numpy().T)

    def ntt(self, coeffs: list[int], size: int) -> list[int]:
        vals = list(coeffs) + [0] * (size - len(coeffs))
        if size >= self.DEVICE_THRESHOLD:
            return self.from_rows(self._device_fft(self.to_rows(vals), inverse=False))
        return hp.host_ntt(vals, self._w(size), self.p)

    def intt(self, evals: list[int]) -> list[int]:
        size = len(evals)
        if size >= self.DEVICE_THRESHOLD:
            return self.from_rows(self._device_fft(self.to_rows(list(evals)), inverse=True))
        return hp.host_intt(evals, self._w(size), self.p)

    # -- row-based transforms (Montgomery u64 rows in/out, no int lists) ----
    def _fft_rows(self, rows: np.ndarray, size: int, inverse: bool) -> np.ndarray:
        n = rows.shape[0]
        if n < size:
            rows = np.concatenate([rows, np.zeros((size - n, self.nf.nl), "<u8")])
        if size >= self.DEVICE_THRESHOLD:
            return self._device_fft(rows, inverse)
        vals = self.from_rows(rows)
        w = self._w(size)
        out = hp.host_intt(vals, w, self.p) if inverse else hp.host_ntt(vals, w, self.p)
        return self.to_rows(out)

    def ntt_rows(self, rows: np.ndarray, size: int) -> np.ndarray:
        return self._fft_rows(rows, size, inverse=False)

    def intt_rows(self, rows: np.ndarray) -> np.ndarray:
        return self._fft_rows(rows, rows.shape[0], inverse=True)

    def coset_ntt_rows(self, rows: np.ndarray, size: int) -> np.ndarray:
        """Evaluations over g*H: scale row i by g^i, then NTT."""
        nf = self.nf
        n = rows.shape[0]
        if n < size:
            rows = np.concatenate([rows, np.zeros((size - n, nf.nl), "<u8")])
        pw = nf.geom_seq(size, nf.ints_to_mont([self.spec.mult_gen])[0], nf.one_mont64)
        return self.ntt_rows(nf.mont_mul(rows, pw), size)

    def coset_intt_rows(self, rows: np.ndarray) -> np.ndarray:
        nf = self.nf
        size = rows.shape[0]
        out = self.intt_rows(rows)
        ginv = pow(self.spec.mult_gen, -1, self.p)
        pw = nf.geom_seq(size, nf.ints_to_mont([ginv])[0], nf.one_mont64)
        return nf.mont_mul(out, pw)


# ---------------------------------------------------------------------------
# containers
# ---------------------------------------------------------------------------


@dataclass
class IndexInfo:
    curve: str
    n_h: int  # |H|
    n_k: int  # |K|
    n_x: int  # |X|
    num_instance: int


@dataclass
class IndexVerifierKey:
    info: IndexInfo
    pp: kzg.UniversalParams
    matrix_comms: dict  # {"A": (row, col, val) Commitments, ...}


@dataclass
class IndexProverKey:
    info: IndexInfo
    pp: kzg.UniversalParams
    ivk: IndexVerifierKey
    entries: dict  # {"A": [(row_pos, col_pos, val)], ...} with H positions
    matrix_polys: dict  # {"A": (row_coeffs, col_coeffs, valhat_coeffs)}
    var_pos: list[int]  # variable index -> H position


@dataclass
class MarlinProof:
    curve: str
    comms1: tuple  # (w_hat, z_A, z_B, mask) commitments
    comms2: tuple  # (g_1 [bounded], h_1)
    comms3: tuple  # (g_2 [bounded], h_2)
    sigma3: int
    evals_beta1: dict  # name -> value
    evals_beta2: dict
    proof_beta1: kzg.OpeningProof  # batched
    proof_beta2: kzg.OpeningProof


# ---------------------------------------------------------------------------
# universal setup + indexer
# ---------------------------------------------------------------------------


def max_degree_bound(num_constraints: int, num_variables: int, num_non_zero: int) -> int:
    """SRS degree covering every committed polynomial: dominated by h_2
    (deg 6|K| - 7), or by the mask's 3|H|."""
    n_k = _next_pow2(max(num_non_zero, 2))
    n_h = _next_pow2(max(num_constraints, num_variables, 2))
    return max(6 * n_k, 3 * n_h)


def universal_setup(
    num_constraints: int,
    num_variables: int,
    num_non_zero: int,
    curve: str = "bls12_381",
    rng=None,
    device=None,
    phase_times: dict | None = None,
) -> kzg.UniversalParams:
    """Marlin::universal_setup: the KZG SRS of ``max_degree_bound`` on
    `device` (default the card).  rng defaults to OS entropy; tests and the
    harness pass utils.rng.test_rng().  phase_times: a dict to receive host
    seconds per phase (synchronizing the card between phases)."""
    dev = devmod.resolve(device)
    mark = obs.PhaseClock(phase_times, dev)
    d = max_degree_bound(num_constraints, num_variables, num_non_zero)
    pp = kzg.setup(d, curve=curve, rng=rng, device=dev)
    mark("srs")
    return pp


def index(pp: kzg.UniversalParams, cs: ConstraintSystem, device=None,
          phase_times: dict | None = None):
    """AHP indexer: arithmetize A/B/C into row/col/val polynomials (their
    inverse NTTs on `device`, default the card) and commit to them under
    `pp` (on pp's device), over the SRS's curve.  The circuit must fit the
    universal_setup sizes, or a commitment raises.  phase_times as in
    ``universal_setup``."""
    curve = pp.curve
    cfg = pairing_config(curve)
    dev = devmod.resolve(device)
    mark = obs.PhaseClock(phase_times, dev)
    ni, nv, nc = cs.num_instance, cs.num_variables, cs.num_constraints
    n_x = _next_pow2(ni)
    # n_h holds all constraints, all variables PLUS the unused X slots
    # (witnesses may not occupy X positions), and X twice
    n_h = _next_pow2(max(nc, nv + n_x - ni, n_x * 2))
    nnz = max(sum(len(lc) for lc in cs.A), sum(len(lc) for lc in cs.B),
              sum(len(lc) for lc in cs.C), 2)
    n_k = _next_pow2(nnz)
    info = IndexInfo(curve=curve, n_h=n_h, n_k=n_k, n_x=n_x, num_instance=ni)

    spec = cfg.fr_spec
    p = spec.p
    w_h = pow(spec.two_adic_root, (1 << spec.two_adicity) // n_h, p)

    # variable -> H position: instance i at i * (n_h / n_x) (X is the
    # index-n/n_x subgroup); witnesses avoid every X position and fill the
    # remaining H slots in order
    stride = n_h // n_x
    x_positions = {i * stride for i in range(n_x)}
    var_pos = [0] * nv
    for i in range(ni):
        var_pos[i] = i * stride
    free = [j for j in range(n_h) if j not in x_positions]
    for k, i in enumerate(range(ni, nv)):
        var_pos[i] = free[k]

    wpow = [1] * n_h
    for j in range(1, n_h):
        wpow[j] = wpow[j - 1] * w_h % p

    engine = PolyEngine(spec, dev)
    n_h_inv = pow(n_h, -1, p)

    def arithmetize(rows):
        entries = []
        for j, lc in enumerate(rows):
            for i, c in lc.items():
                entries.append((j, var_pos[i], c % p))
        if len(entries) > n_k:
            raise ValueError(f"{len(entries)} entries exceed |K| = {n_k}")
        row_e = [1] * n_k  # pad with H-identity (val 0)
        col_e = [1] * n_k
        valhat_e = [0] * n_k
        for k, (j, pos, c) in enumerate(entries):
            row_e[k] = wpow[j % n_h]
            col_e[k] = wpow[pos]
            # val_hat = val / u_H(col, col), u_H(c, c) = n_h c^(n_h - 1) = n_h / c
            valhat_e[k] = c * wpow[pos] % p * n_h_inv % p
        return entries, (engine.intt(row_e), engine.intt(col_e), engine.intt(valhat_e))

    entries, polys, comms = {}, {}, {}
    for name, rows in zip(MATRICES, (cs.A, cs.B, cs.C)):
        entries[name], polys[name] = arithmetize(rows)
    mark("arithmetize")
    flat = kzg.commit_many(pp, [(hp.trim(c) or [0], None) for n in MATRICES for c in polys[n]])
    for i, name in enumerate(MATRICES):
        comms[name] = tuple(flat[3 * i : 3 * i + 3])
    mark("commit")

    ivk = IndexVerifierKey(info=info, pp=pp, matrix_comms=comms)
    ipk = IndexProverKey(
        info=info, pp=pp, ivk=ivk, entries=entries, matrix_polys=polys, var_pos=var_pos
    )
    return ipk, ivk


# ---------------------------------------------------------------------------
# prover
# ---------------------------------------------------------------------------


def _x_subdomain(spec, n_h: int, n_x: int):
    p = spec.p
    w_h = pow(spec.two_adic_root, (1 << spec.two_adicity) // n_h, p)
    w_x = pow(w_h, n_h // n_x, p)
    return [pow(w_x, i, p) for i in range(n_x)]


def prove(ipk: IndexProverKey, cs: ConstraintSystem, rng=None, device=None,
          phase_times: dict | None = None) -> MarlinProof:
    """A Marlin proof for `cs` under the index: transforms on `device`
    (default the card), commitments on the SRS's device.  rng defaults to
    OS entropy (the masks r_w, r_a, r_b, then the mask polynomial's 3|H|
    coefficients); tests pass utils.rng.test_rng().  phase_times as in
    ``universal_setup``."""
    info = ipk.info
    cfg = pairing_config(info.curve)
    spec = cfg.fr_spec
    p = cfg.r
    n_h, n_k, n_x, ni = info.n_h, info.n_k, info.n_x, info.num_instance
    dev = devmod.resolve(device)
    mark = obs.PhaseClock(phase_times, dev)
    engine = PolyEngine(spec, dev)
    nf = engine.nf
    pp = ipk.pp

    # --- z over H, z_A/z_B/z_C evals --------------------------------------
    z_evals = [0] * n_h
    for i, v in enumerate(cs.values):
        z_evals[ipk.var_pos[i]] = v % p
    zm = {}
    for name in MATRICES:
        ev = [0] * n_h
        for (j, pos, c) in ipk.entries[name]:
            ev[j % n_h] = (ev[j % n_h] + c * z_evals[pos]) % p
        zm[name] = ev

    # --- w_hat: (z_hat - x_hat) / v_X --------------------------------------
    xs = _x_subdomain(spec, n_h, n_x)
    x_vals = [cs.values[i] % p if i < ni else 0 for i in range(n_x)]
    x_hat = hp.lagrange_interpolate(xs, x_vals, p)
    z_hat = engine.intt(z_evals)
    diff = hp.poly_add(z_hat, hp.poly_scale(x_hat, p - 1, p), p)
    w_hat, rem = hp.divide_by_vanishing(diff, n_x, p)
    if hp.trim(rem):
        raise ValueError("z - x_hat does not vanish on X: the witness does not fit the index")
    za_hat = engine.intt(zm["A"])
    zb_hat = engine.intt(zm["B"])

    # --- zero-knowledge masking: z_A + r_a v_H, z_B + r_b v_H, and
    # w + r_w (v_H / v_X) so that z + r_w v_H stays consistent ------------
    rng = rng or frng.secure_rng()
    r_w, r_a, r_b = (frng.field_element(rng, p) for _ in range(3))

    def _add_vh(poly, r):
        out = list(poly) + [0] * max(0, n_h + 1 - len(poly))
        out[0] = (out[0] - r) % p
        out[n_h] = (out[n_h] + r) % p
        return out

    za_hat = _add_vh(za_hat, r_a)
    zb_hat = _add_vh(zb_hat, r_b)
    z_hat = _add_vh(z_hat, r_w)
    w_hat = list(w_hat) + [0] * max(0, n_h - n_x + 1 - len(w_hat))
    for i in range(0, n_h - n_x + 1, n_x):
        w_hat[i] = (w_hat[i] + r_w) % p

    # committed random mask polynomial of degree 3|H| - 1, sum over H = 0
    mask = [frng.field_element(rng, p) for _ in range(3 * n_h)]
    mask[0] = (-(mask[n_h] + mask[2 * n_h])) % p
    mark("witness")
    c_mask, c_w, c_za, c_zb = kzg.commit_many(pp, [
        (mask, None), (hp.trim(w_hat) or [0], None), (hp.trim(za_hat) or [0], None),
        (hp.trim(zb_hat) or [0], None)])
    mark("commit_round1")

    tr = Transcript(b"zkmember_tpu/marlin")
    fw = (p.bit_length() + 7) // 8  # field width: 32 B (BLS Fr) / 48 B (BW6 Fr)
    for i in range(ni):
        tr.absorb_int(cs.values[i], fw)
    for c in (c_w, c_za, c_zb, c_mask):
        tr.absorb_point(c.c)
    alpha = tr.challenge(p)
    eta = {"A": tr.challenge(p), "B": tr.challenge(p), "C": tr.challenge(p)}

    # --- outer sumcheck -----------------------------------------------------
    v_h_alpha = (pow(alpha, n_h, p) - 1) % p
    wpow = [1] * n_h
    w_h = pow(spec.two_adic_root, (1 << spec.two_adicity) // n_h, p)
    for j in range(1, n_h):
        wpow[j] = wpow[j - 1] * w_h % p
    denom = hp.batch_inverse([(alpha - w) % p for w in wpow], p)
    r_alpha_h = [v_h_alpha * d % p for d in denom]  # r(alpha, w^j)

    # t(Y) over H: sum_M eta_M sum_entries r(alpha, row) val at col
    t_evals = [0] * n_h
    for name in MATRICES:
        e_m = eta[name]
        for (j, pos, c) in ipk.entries[name]:
            t_evals[pos] = (t_evals[pos] + e_m * r_alpha_h[j % n_h] % p * c) % p
    t_hat = engine.intt(t_evals)

    # q_1 (degree <= 3|H|) from its evaluations on a 4|H| domain
    big = 4 * n_h
    r_alpha_coeffs = [pow(alpha, n_h - 1 - k, p) for k in range(n_h)]  # r(alpha, X)
    za_e = engine.ntt_rows(engine.to_rows(za_hat), big)
    zb_e = engine.ntt_rows(engine.to_rows(zb_hat), big)
    z_e = engine.ntt_rows(engine.to_rows(z_hat), big)
    t_e = engine.ntt_rows(engine.to_rows(t_hat), big)
    ra_e = engine.ntt_rows(engine.to_rows(r_alpha_coeffs), big)
    comb = np.zeros((big, nf.nl), "<u8")
    comb = nf.mul_const_add(comb, za_e, nf.ints_to_mont([eta["A"]])[0])
    comb = nf.mul_const_add(comb, zb_e, nf.ints_to_mont([eta["B"]])[0])
    comb = nf.mul_const_add(comb, nf.mont_mul(za_e, zb_e), nf.ints_to_mont([eta["C"]])[0])
    q1_rows = nf.sub(nf.mont_mul(ra_e, comb), nf.mont_mul(t_e, z_e))
    q1 = hp.trim(hp.poly_add(engine.from_rows(engine.intt_rows(q1_rows)), mask, p))
    h1, rem = hp.divide_by_vanishing(q1, n_h, p)
    rem = hp.trim(rem)
    if rem and rem[0] != 0:
        raise ValueError("outer sumcheck: the sum over H is not zero")
    g1 = rem[1:] if len(rem) > 1 else [0]
    mark("outer_sumcheck")

    c_g1, c_h1 = kzg.commit_many(pp, [(g1, n_h - 2), (hp.trim(h1) or [0], None)])
    mark("commit_round2")
    for c in (c_g1.c, c_g1.shifted, c_h1.c):
        tr.absorb_point(c)
    beta1 = tr.challenge(p)

    # --- inner sumcheck: dens = (alpha - row)(beta1 - col) per matrix, one
    # batched inverse, eta vv-weighted accumulate -------------------------
    v_h_beta1 = (pow(beta1, n_h, p) - 1) % p
    vv = v_h_alpha * v_h_beta1 % p
    alpha_m = nf.ints_to_mont([alpha])[0]
    beta1_m = nf.ints_to_mont([beta1])[0]
    f_rows = np.zeros((n_k, nf.nl), "<u8")
    for name in MATRICES:
        row_c, col_c, valhat_c = ipk.matrix_polys[name]
        re = engine.ntt_rows(engine.to_rows(list(row_c)), n_k)
        ce = engine.ntt_rows(engine.to_rows(list(col_c)), n_k)
        ve = engine.ntt_rows(engine.to_rows(list(valhat_c)), n_k)
        dens = nf.mont_mul(nf.rsub_const(re, alpha_m), nf.rsub_const(ce, beta1_m))
        dinv = nf.batch_inv(dens)
        e_m = nf.ints_to_mont([eta[name] * vv % p])[0]
        f_rows = nf.mul_const_add(f_rows, nf.mont_mul(ve, dinv), e_m)
    sigma3 = sum(engine.from_rows(f_rows)) % p
    f_hat = engine.from_rows(engine.intt_rows(f_rows))
    if f_hat[0] != sigma3 * pow(n_k, -1, p) % p:
        raise ValueError("inner sumcheck: f_hat(0) is not sigma3 / |K|")
    g2 = hp.trim(f_hat[1:]) or [0]
    mark("inner_sumcheck")

    return _finish_prove(
        ipk, tr, pp, engine, p, spec, mark,
        (c_w, c_za, c_zb, c_mask), (c_g1, c_h1),
        w_hat, za_hat, zb_hat, mask, g1, h1,
        f_hat, g2, sigma3, alpha, eta, beta1, vv,
    )


def _finish_prove(
    ipk, tr, pp, engine, p, spec, mark,
    comms1, comms2,
    w_hat, za_hat, zb_hat, mask, g1, h1,
    f_hat, g2, sigma3, alpha, eta, beta1, vv,
):
    """Round 3 onward: h_2 on a COSET of the 8|K| domain (v_K nonzero
    there), then commitments, queries and batched openings."""
    info = ipk.info
    n_k = info.n_k
    n_h = info.n_h
    big_k = 8 * n_k
    g = spec.mult_gen
    nf = engine.nf

    def cos(coeffs):
        return engine.coset_ntt_rows(engine.to_rows(list(coeffs)), big_k)

    rce = {n: cos(ipk.matrix_polys[n][0]) for n in MATRICES}
    cce = {n: cos(ipk.matrix_polys[n][1]) for n in MATRICES}
    vce = {n: cos(ipk.matrix_polys[n][2]) for n in MATRICES}
    f_big = cos(f_hat)
    w_bigk = pow(spec.two_adic_root, (1 << spec.two_adicity) // big_k, p)
    vk_cycle = [(pow(g, n_k, p) * pow(w_bigk, i * n_k, p) - 1) % p for i in range(8)]
    vk_inv_big = np.tile(nf.batch_inv(nf.ints_to_mont(vk_cycle)), (big_k // 8, 1))
    alpha_m = nf.ints_to_mont([alpha])[0]
    beta1_m = nf.ints_to_mont([beta1])[0]
    b_m = {n: nf.mont_mul(nf.rsub_const(rce[n], alpha_m), nf.rsub_const(cce[n], beta1_m))
           for n in MATRICES}
    b_ab = nf.mont_mul(b_m["A"], b_m["B"])
    b_all = nf.mont_mul(b_ab, b_m["C"])
    others = {"A": nf.mont_mul(b_m["B"], b_m["C"]), "B": nf.mont_mul(b_m["A"], b_m["C"]),
              "C": b_ab}
    a_rows = np.zeros_like(b_all)
    for n in MATRICES:
        ev = nf.ints_to_mont([eta[n] * vv % p])[0]
        a_rows = nf.mul_const_add(a_rows, nf.mont_mul(vce[n], others[n]), ev)
    h2_rows = nf.mont_mul(nf.sub(a_rows, nf.mont_mul(b_all, f_big)), vk_inv_big)
    h2 = hp.trim(engine.from_rows(engine.coset_intt_rows(h2_rows))) or [0]
    mark("h2")

    fw = (p.bit_length() + 7) // 8  # the same width for EVERY field absorb
    c_g2, c_h2 = kzg.commit_many(pp, [(g2, n_k - 2), (h2, None)])
    mark("commit_round3")
    tr.absorb_int(sigma3, fw)
    for c in (c_g2.c, c_g2.shifted, c_h2.c):
        tr.absorb_point(c)
    beta2 = tr.challenge(p)

    # --- openings -----------------------------------------------------------
    D = pp.max_degree
    c_w, c_za, c_zb, c_mask = comms1
    c_g1, c_h1 = comms2

    def shifted_poly(coeffs, bound):
        return [0] * (D - bound) + list(coeffs)

    beta1_set = [
        ("w_hat", hp.trim(w_hat) or [0]),
        ("z_a", hp.trim(za_hat) or [0]),
        ("z_b", hp.trim(zb_hat) or [0]),
        ("mask", hp.trim(mask) or [0]),
        ("g_1", g1),
        ("g_1_shift", shifted_poly(g1, n_h - 2)),
        ("h_1", hp.trim(h1) or [0]),
    ]
    beta2_set = [
        ("g_2", g2),
        ("g_2_shift", shifted_poly(g2, n_k - 2)),
        ("h_2", h2),
    ]
    for n in MATRICES:
        row_c, col_c, valhat_c = ipk.matrix_polys[n]
        beta2_set += [
            (f"row_{n}", hp.trim(row_c) or [0]),
            (f"col_{n}", hp.trim(col_c) or [0]),
            (f"val_{n}", hp.trim(valhat_c) or [0]),
        ]

    def batch_open(point, polys):
        """One synthetic division per polynomial (the remainder is its
        evaluation), the quotients combined with powers of xi as native
        rows: the witness polynomial's rows."""
        rows_list, evals = [], {}
        point_m = nf.ints_to_mont([point])[0]
        for name, coeffs in polys:
            q, rem = nf.synth_div(engine.to_rows(list(coeffs)), point_m)
            rows_list.append(q if len(coeffs) > 1 else None)
            evals[name] = nf.mont_to_ints(rem.reshape(1, -1))[0]
        for name in sorted(evals):
            tr.absorb_int(evals[name], fw)
        xi = tr.challenge(p)
        maxlen = max((q.shape[0] for q in rows_list if q is not None), default=1)
        acc = np.zeros((maxlen, nf.nl), "<u8")
        x = 1
        for q in rows_list:
            if q is not None:
                acc[: q.shape[0]] = nf.mul_const_add(acc[: q.shape[0]], q,
                                                     nf.ints_to_mont([x])[0])
            x = x * xi % p
        return evals, acc

    evals1, acc1 = batch_open(beta1, beta1_set)
    evals2, acc2 = batch_open(beta2, beta2_set)
    mark("open")
    w1, w2 = kzg._msm_powers_many(pp, [(acc1, 0), (acc2, 0)])  # the transcript holds no W
    mark("commit_open")

    return MarlinProof(
        curve=info.curve,
        comms1=comms1,
        comms2=comms2,
        comms3=(c_g2, c_h2),
        sigma3=sigma3,
        evals_beta1=evals1,
        evals_beta2=evals2,
        proof_beta1=kzg.OpeningProof(w=w1),
        proof_beta2=kzg.OpeningProof(w=w2),
    )


# ---------------------------------------------------------------------------
# verifier
# ---------------------------------------------------------------------------


def verify(ivk: IndexVerifierKey, public_inputs: list[int], proof: MarlinProof) -> bool:
    """Replay the transcript, check both sumcheck equations and the degree
    bounds at the queried points, then the two batched KZG pairing checks
    (host)."""
    info = ivk.info
    cfg = pairing_config(info.curve)
    spec = cfg.fr_spec
    p = cfg.r
    n_h, n_k, n_x, ni = info.n_h, info.n_k, info.n_x, info.num_instance
    pp = ivk.pp
    g1c = cfg.mod.G1

    c_w, c_za, c_zb, c_mask = proof.comms1
    c_g1, c_h1 = proof.comms2
    c_g2, c_h2 = proof.comms3

    tr = Transcript(b"zkmember_tpu/marlin")
    full_inputs = [1] + [v % p for v in public_inputs]
    if len(full_inputs) != ni:
        return False
    fw = (p.bit_length() + 7) // 8
    for v in full_inputs:
        tr.absorb_int(v, fw)
    for c in (c_w, c_za, c_zb, c_mask):
        tr.absorb_point(c.c)
    alpha = tr.challenge(p)
    eta = {"A": tr.challenge(p), "B": tr.challenge(p), "C": tr.challenge(p)}
    for c in (c_g1.c, c_g1.shifted, c_h1.c):
        tr.absorb_point(c)
    beta1 = tr.challenge(p)
    tr.absorb_int(proof.sigma3, fw)
    for c in (c_g2.c, c_g2.shifted, c_h2.c):
        tr.absorb_point(c)
    beta2 = tr.challenge(p)

    e1 = proof.evals_beta1
    e2 = proof.evals_beta2
    for name in sorted(e1):
        tr.absorb_int(e1[name], fw)
    xi1 = tr.challenge(p)
    for name in sorted(e2):
        tr.absorb_int(e2[name], fw)
    xi2 = tr.challenge(p)

    # --- outer sumcheck equation at beta1 ----------------------------------
    v_h_alpha = (pow(alpha, n_h, p) - 1) % p
    v_h_beta1 = (pow(beta1, n_h, p) - 1) % p
    v_x_beta1 = (pow(beta1, n_x, p) - 1) % p
    xs = _x_subdomain(spec, n_h, n_x)
    x_vals = full_inputs + [0] * (n_x - ni)
    x_hat_beta1 = hp.poly_eval(hp.lagrange_interpolate(xs, x_vals, p), beta1, p)
    z_beta1 = (e1["w_hat"] * v_x_beta1 + x_hat_beta1) % p
    r_alpha_beta1 = (v_h_alpha - v_h_beta1) * pow((alpha - beta1) % p, -1, p) % p
    lhs = (e1["h_1"] * v_h_beta1 + beta1 * e1["g_1"]) % p
    rhs = (
        e1["mask"]
        + r_alpha_beta1
        * ((eta["A"] * e1["z_a"] + eta["B"] * e1["z_b"] + eta["C"] * e1["z_a"] * e1["z_b"]) % p)
        - proof.sigma3 * z_beta1
    ) % p
    if lhs != rhs:
        return False

    # --- inner sumcheck equation at beta2 ----------------------------------
    v_k_beta2 = (pow(beta2, n_k, p) - 1) % p
    vv = v_h_alpha * v_h_beta1 % p
    b_m = {n: (alpha - e2[f"row_{n}"]) * (beta1 - e2[f"col_{n}"]) % p for n in MATRICES}
    b_all = b_m["A"] * b_m["B"] % p * b_m["C"] % p
    a_val = 0
    for n in MATRICES:
        others = 1
        for m in MATRICES:
            if m != n:
                others = others * b_m[m] % p
        a_val = (a_val + eta[n] * vv % p * e2[f"val_{n}"] % p * others) % p
    f_beta2 = (beta2 * e2["g_2"] + proof.sigma3 * pow(n_k, -1, p)) % p
    if (a_val - b_all * f_beta2) % p != e2["h_2"] * v_k_beta2 % p:
        return False

    # --- degree-bound consistency -------------------------------------------
    D = pp.max_degree
    if e1["g_1_shift"] != e1["g_1"] * pow(beta1, D - (n_h - 2), p) % p:
        return False
    if e2["g_2_shift"] != e2["g_2"] * pow(beta2, D - (n_k - 2), p) % p:
        return False

    # --- batched KZG pairing checks ------------------------------------------
    def batch_check(point, items, evals, prf, xi):
        acc_c, acc_v, x = None, 0, 1
        for name, comm in items:
            acc_c = g1c.add(acc_c, g1c.mul(x, comm)) if comm is not None else acc_c
            acc_v = (acc_v + x * evals[name]) % p
            x = x * xi % p
        lhs_pt = g1c.add(acc_c, g1c.neg(g1c.mul(acc_v, pp.g)))
        return kzg._pairing_check(pp, lhs_pt, prf.w, point)

    items1 = [
        ("w_hat", c_w.c),
        ("z_a", c_za.c),
        ("z_b", c_zb.c),
        ("mask", c_mask.c),
        ("g_1", c_g1.c),
        ("g_1_shift", c_g1.shifted),
        ("h_1", c_h1.c),
    ]
    items2 = [
        ("g_2", c_g2.c),
        ("g_2_shift", c_g2.shifted),
        ("h_2", c_h2.c),
    ]
    for n in MATRICES:
        items2 += [
            (f"row_{n}", ivk.matrix_comms[n][0].c),
            (f"col_{n}", ivk.matrix_comms[n][1].c),
            (f"val_{n}", ivk.matrix_comms[n][2].c),
        ]
    return (batch_check(beta1, items1, e1, proof.proof_beta1, xi1)
            and batch_check(beta2, items2, e2, proof.proof_beta2, xi2))
