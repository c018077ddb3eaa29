"""The port's Marlin building blocks against the JAX package: the Blake2s
transcript, the host polynomial helpers, PolyEngine's device-route NTTs
(plain K2 on the CPU) and KZG over the SRS Straus tables (plain K1 and the
finish on the CPU).

Both sides draw from the same seeds.  Transcript challenges, polynomial
coefficients and NTT rows must be equal as bytes and ints; SRS points as
Montgomery planes; commitments and opening witnesses as affine points.
The port's KZG takes the table route with the table cut into rows of
LANES = 8 lanes here (so commitments span several rows and a shifted
commitment crosses a row boundary); the reference's takes its
non-table MSM on the CPU.
"""

import random

import numpy as np
import pytest
import torch

from zkmember_tpu.curves import bls12_381 as jbls, bw6_761 as jbw6
from zkmember_tpu.snark import kzg as jkzg, marlin as jmarlin
from zkmember_tpu.snark.groth16 import pairing_config as jpairing_config
from zkmember_tpu.snark.transcript import Transcript as JTranscript
from zkmember_tpu.utils import poly as jpoly
from zkmember_tpu.utils import rng as jrng
from zkmember_tpu_torch.curves import bls12_381 as bls, bw6_761 as bw6
from zkmember_tpu_torch.snark import groth16, kzg, marlin
from zkmember_tpu_torch.snark.transcript import Transcript
from zkmember_tpu_torch.utils import poly
from zkmember_tpu_torch.utils import rng as frng

R = bls.R
LANES = 8  # the port's SRS table row width in these tests


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _pt(P):
    """A host affine point of either package as ints (None stays None)."""
    return None if P is None else (P[0].v, P[1].v)


def _pt2(P):
    """A host affine G2 point over Fq2 as ints."""
    return tuple(tuple(c.v for c in coord.coeffs) for coord in P)


# ---------------------------------------------------------------------------
# transcript
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("curve", ["bls12_381", "bw6_761"])
def test_transcript_challenges_equal_byte_for_byte(curve):
    """The same absorbs (ints at the field width, a 377-bit BW6-761 Fr value
    among them, points and the identity, bytes) give the same challenges."""
    mods = {"bls12_381": (bls, jbls), "bw6_761": (bw6, jbw6)}[curve]
    r = mods[0].R
    fw = (r.bit_length() + 7) // 8
    rng = random.Random(7)
    ints = [rng.randrange(r) for _ in range(5)] + [r - 1]
    ks = [rng.randrange(1, r) for _ in range(2)]
    outs = []
    for mod, T in zip(mods, (Transcript, JTranscript)):
        tr = T(b"zkmember_tpu/marlin")
        for v in ints:
            tr.absorb_int(v, fw)
        for k in ks:
            tr.absorb_point(mod.G1.mul(k, mod.G1_GEN))
        tr.absorb_point(None)
        tr.absorb_bytes(b"membership")
        outs.append([tr.challenge(r) for _ in range(4)] + [tr._state])
    assert outs[0] == outs[1]
    assert all(0 <= c < r for c in outs[0][:4]) and len(set(outs[0][:4])) == 4


# ---------------------------------------------------------------------------
# host polynomial helpers
# ---------------------------------------------------------------------------


def _poly_cases(rng):
    n = 16
    w = pow(jbls.ROOT_OF_UNITY, (1 << jbls.TWO_ADICITY) // n, R)
    a = [rng.randrange(R) for _ in range(n)]
    b = [rng.randrange(R) for _ in range(11)]
    f = [rng.randrange(R) for _ in range(3 * n + 5)] + [0, 0]
    xs = [rng.randrange(R) for _ in range(4)]
    ys = [rng.randrange(R) for _ in range(4)]
    vals = [rng.randrange(R) for _ in range(9)] + [0]
    return {
        "host_ntt": ("host_ntt", (a, w, R)),
        "host_intt": ("host_intt", (a, w, R)),
        "poly_add": ("poly_add", (a, b, R)),
        "poly_scale": ("poly_scale", (b, xs[0], R)),
        "poly_eval": ("poly_eval", (f, xs[1], R)),
        "trim": ("trim", (f,)),
        "trim_long_tail": ("trim", (a + [0] * 3 * n,)),
        "trim_all_zero": ("trim", ([0] * 7,)),
        "divide_by_vanishing": ("divide_by_vanishing", (f, n, R)),
        "batch_inverse": ("batch_inverse", (vals, R)),
        "lagrange_interpolate": ("lagrange_interpolate", (xs, ys, R)),
    }


@pytest.mark.parametrize("case", list(_poly_cases(random.Random(0))))
def test_poly_helpers_equal_as_ints(case):
    name, args = _poly_cases(random.Random(11))[case]
    got = getattr(poly, name)(*args)
    assert got == getattr(jpoly, name)(*args)
    if name == "host_intt":
        w = args[1]
        assert poly.host_ntt(got, w, R) == args[0]


# ---------------------------------------------------------------------------
# PolyEngine: the device route (limb-major NTT over plain K2 on the CPU)
# ---------------------------------------------------------------------------

N_DEVICE = 1 << 12  # above PolyEngine.DEVICE_THRESHOLD: the device route


@pytest.fixture(scope="module")
def engines():
    spec = groth16.pairing_config("bls12_381").fr_spec
    eng = marlin.PolyEngine(spec, "cpu")
    jeng = jmarlin.PolyEngine(jpairing_config("bls12_381").fr_spec)
    rows = eng.to_rows([random.Random(3).randrange(R) for _ in range(N_DEVICE)])
    return eng, jeng, rows


@pytest.mark.parametrize("transform", ["ntt_rows", "intt_rows", "coset_ntt_rows",
                                       "coset_intt_rows"])
def test_poly_engine_device_route_matches_reference(engines, transform):
    eng, jeng, rows = engines
    assert N_DEVICE >= marlin.PolyEngine.DEVICE_THRESHOLD
    args = (rows, N_DEVICE) if transform in ("ntt_rows", "coset_ntt_rows") else (rows,)
    got = getattr(eng, transform)(*args)
    want = getattr(jeng, transform)(*args)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    inverse = {"ntt_rows": "intt_rows", "intt_rows": "ntt_rows",
               "coset_ntt_rows": "coset_intt_rows", "coset_intt_rows": "coset_ntt_rows"}
    back = getattr(eng, inverse[transform])(*((got, N_DEVICE) if "intt" in transform else (got,)))
    assert np.array_equal(back, rows)


def test_poly_engine_int_lists_match_reference(engines):
    """ntt / intt on int lists, below (host) and above (device) the
    threshold."""
    eng, jeng, _ = engines
    rng = random.Random(5)
    for size in (64, N_DEVICE):
        coeffs = [rng.randrange(R) for _ in range(size - 3)]
        ev = eng.ntt(coeffs, size)
        assert ev == jeng.ntt(coeffs, size)
        assert eng.intt(ev) == jeng.intt(ev) == coeffs + [0, 0, 0]


# ---------------------------------------------------------------------------
# KZG
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def srs():
    """kzg.setup(16) in both packages from test_rng(); the port's
    commitments below take rows of LANES lanes (3 rows for 17 powers)."""
    pp = kzg.setup(16, curve="bls12_381", rng=frng.test_rng(), device="cpu")
    jpp = jkzg.setup(16, curve="bls12_381", rng=jrng.test_rng())
    return pp, jpp


def test_setup_gives_the_same_srs(srs):
    pp, jpp = srs
    for got, want in ((pp.powers.x, jpp.powers.x), (pp.powers.y, jpp.powers.y)):
        assert tuple(got.shape) == (17, 24)
        assert np.array_equal(got.numpy().astype(np.uint32), np.asarray(want, np.uint32))
    assert (pp.max_degree, _pt(pp.g)) == (jpp.max_degree, _pt(jpp.g))
    assert (_pt2(pp.h), _pt2(pp.beta_h)) == (_pt2(jpp.h), _pt2(jpp.beta_h))


@pytest.mark.parametrize("bound", [None, 10, 12], ids=["unbounded", "bound10", "bound12"])
def test_commit_matches_reference(srs, bound):
    """Commitments as points; bound 10 shifts the polynomial to powers
    6..13 (rows 0-1), bound 12 to 4..11 (rows 0-1), the unbounded one sits
    on row 0 only."""
    pp, jpp = srs
    coeffs = [3, 1, 4, 1, 5, 9, 2, 6]
    c = kzg.commit_many(pp, [(coeffs, bound)], LANES)[0]
    jc = jkzg.commit(jpp, coeffs, degree_bound=bound)
    assert _pt(c.c) == _pt(jc.c) and c.c is not None
    assert _pt(c.shifted) == _pt(jc.shifted) and c.degree_bound == bound


def test_commit_many_spans_rows_and_equals_single_commits(srs):
    """One batch of polynomials over every row of the table (17 powers in
    rows of 8), a zero polynomial and a bounded one: each equals the
    reference's single commitment."""
    pp, jpp = srs
    rng = random.Random(9)
    full = [rng.randrange(R) for _ in range(17)]
    polys = [(full, None), ([0], None), ([5, 7, 11], 3), (full[:9], None)]
    got = kzg.commit_many(pp, polys, LANES)
    for (coeffs, bound), c in zip(polys, got):
        jc = jkzg.commit(jpp, coeffs, degree_bound=bound)
        assert (_pt(c.c), _pt(c.shifted)) == (_pt(jc.c), _pt(jc.shifted))
    assert got[1].c is None


def test_open_and_check_match_reference(srs):
    pp, jpp = srs
    coeffs = [random.Random(4).randrange(R) for _ in range(14)]
    z = 123456789
    comm = kzg.commit(pp, coeffs)
    v, prf = kzg.open_at(pp, coeffs, z)
    jv, jprf = jkzg.open_at(jpp, coeffs, z)
    assert v == jv == kzg.poly_eval(coeffs, z, R)
    assert _pt(prf.w) == _pt(jprf.w)
    q = kzg._synthetic_division(coeffs, z, R)
    assert q == jkzg._synthetic_division(coeffs, z, R)
    assert _pt(kzg._msm_powers_many(pp, [(q, 0)], LANES)[0]) == _pt(jprf.w)  # rows 0-1
    assert kzg.check(pp, comm, z, v, prf)
    assert not kzg.check(pp, comm, z, (v + 1) % R, prf)


def test_batch_check_same_point_matches_reference(srs):
    pp, jpp = srs
    rng = random.Random(6)
    polys = [[rng.randrange(R) for _ in range(k)] for k in (5, 12, 17)]
    z, xi = rng.randrange(R), rng.randrange(R)
    comms = kzg.commit_many(pp, [(p, None) for p in polys], LANES)
    opened = [kzg.open_at(pp, p, z) for p in polys]
    vals = [v for v, _ in opened]
    prfs = [p for _, p in opened]
    assert vals == [jkzg.open_at(jpp, p, z)[0] for p in polys]
    assert kzg.batch_check_same_point(pp, comms, z, vals, prfs, xi)
    bad = [vals[0], (vals[1] + 1) % R, vals[2]]
    assert not kzg.batch_check_same_point(pp, comms, z, bad, prfs, xi)
    jcomms = [jkzg.Commitment(c=c.c) for c in comms]
    jprfs = [jkzg.OpeningProof(w=p.w) for p in prfs]
    assert jkzg.batch_check_same_point(jpp, jcomms, z, vals, jprfs, xi)


def test_degree_bound_check(srs):
    pp, _ = srs
    coeffs = [3, 1, 4, 1, 5]
    bound = 8
    comm = kzg.commit_many(pp, [(coeffs, bound)], LANES)[0]
    z = 987654321
    v = kzg.poly_eval(coeffs, z, R)
    v_sh = v * pow(z, pp.max_degree - bound, R) % R
    assert kzg.check_degree_bound(pp, comm, z, v, v_sh)
    assert not kzg.check_degree_bound(pp, comm, z, v, (v_sh + 1) % R)
    assert not kzg.check_degree_bound(pp, kzg.Commitment(c=comm.c), z, v, v_sh)
    with pytest.raises(ValueError):
        kzg.commit(pp, coeffs, degree_bound=3)
    with pytest.raises(ValueError):
        kzg._msm_powers(pp, coeffs, offset=pp.max_degree - 2)


def test_table_lanes():
    assert kzg.table_lanes(16) == 64
    assert kzg.table_lanes(192) == 256
    assert kzg.table_lanes(98_304) == kzg.table_lanes(196_608) == 1 << 14
