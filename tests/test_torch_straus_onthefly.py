"""The port's on-the-fly Straus route against the JAX package: per-call
tables (``straus.window_sums``, ``msm_program``, ``msm_program_chunked``),
the boolean-scalar MSM (``bool_msm_program``) and KZG past its table
budget.

Points and scalars come from seeded random.Random; the JAX side runs the
reference's XLA composition on the CPU, the host curve is an independent
oracle, and the port runs the plain versions of K1, K2 and the finish.
Points are compared after normalisation: the projective representative
depends on the order of the adds.
"""

import dataclasses
import random

import numpy as np
import pytest
import torch

from zkmember_tpu.curves import bls12_381 as jbls, device as jcdv
from zkmember_tpu.fields import device as dv, lm as jlm
from zkmember_tpu.msm import straus as jstraus
from zkmember_tpu.snark import kzg as jkzg
from zkmember_tpu.utils import rng as jrng
from zkmember_tpu_torch.curves import bls12_381 as bls
from zkmember_tpu_torch.fields import spec as fs
from zkmember_tpu_torch.msm import straus
from zkmember_tpu_torch.snark import groth16, kzg, prove_lm
from zkmember_tpu_torch.utils import rng as frng

NWIN = 8  # 32-bit scalars: eight 4-bit windows


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _points(curve, gen, count, rng):
    """count distinct points P_0 = a G, P_i = P_(i-1) + b G (cheap on the host)."""
    P, step = curve.mul(rng.randrange(1, bls.R), gen), curve.mul(rng.randrange(1, bls.R), gen)
    out = []
    for _ in range(count):
        out.append(P)
        P = curve.add(P, step)
    return out


def _g1_planes(pts):
    X = fs.to_lm(fs.BLS_FQ.to_mont_host([p[0].v for p in pts]))
    Y = fs.to_lm(fs.BLS_FQ.to_mont_host([p[1].v for p in pts]))
    return np.ascontiguousarray(X), np.ascontiguousarray(Y)


def _g2_planes(pts):
    def plane(i, j):
        return np.ascontiguousarray(
            fs.to_lm(fs.BLS_FQ.to_mont_host([p[i].coeffs[j].v for p in pts])))

    return (plane(0, 0), plane(0, 1)), (plane(1, 0), plane(1, 1))


def _t(a):
    if isinstance(a, tuple):
        return tuple(_t(x) for x in a)
    return torch.from_numpy(np.asarray(a).astype(np.int32))


def _np(c):
    if isinstance(c, tuple):
        return tuple(_np(x) for x in c)
    return c.numpy() if isinstance(c, torch.Tensor) else np.asarray(c)


def _row(P, i):
    return tuple(straus._map_coord(lambda c: c[i], x) for x in P)


def _ints(pt):
    if pt is None:
        return None

    def c(v):
        return tuple(int(x.v) for x in v.coeffs) if hasattr(v, "coeffs") else int(v.v)

    return (c(pt[0]), c(pt[1]))


def _host_msm(curve, pts, scalars):
    acc = None
    for s, p in zip(scalars, pts):
        acc = curve.add(acc, curve.mul(s, p))
    return acc


def _ops(g2: bool):
    return prove_lm.sw_ops(groth16.pairing_config("bls12_381"), g2, "cpu")


def _jops(g2: bool):
    if g2:
        return jcdv.sw_ops_for(jlm.Fp2OpsLM(dv.BLS_FQ2), (12, 12), "bls12_381_g2/lm")
    return jcdv.sw_ops_for(jlm.FpOpsLM(dv.BLS_FQ), 12, "bls12_381_g1/lm")


def _g1_case(seed: int, R: int, B: int):
    """R rows of B random G1 points and 32-bit scalars: host points and
    scalars per row, limb-major planes (R, n, B) and scalar limbs (R, 16, B)."""
    rng = random.Random(seed)
    pts = [_points(bls.G1, bls.G1_GEN, B, rng) for _ in range(R)]
    scal = [[rng.randrange(1 << 32) for _ in range(B)] for _ in range(R)]
    planes = [_g1_planes(p) for p in pts]
    X = np.stack([p[0] for p in planes])
    Y = np.stack([p[1] for p in planes])
    z = np.stack([np.ascontiguousarray(fs.to_lm(fs.ints_to_limbs(s, 16))) for s in scal])
    return pts, scal, X, Y, z


def test_window_sums_equal_the_reference_per_window_and_row():
    """Two rows of 64 lanes: every window sum of every row equals the JAX
    window_sums' after normalisation, the Horner join of them equals
    msm_program's point and the host MSM."""
    pts, scal, X, Y, z = _g1_case(31, 2, 64)
    ops = _ops(False)
    S = straus.window_sums(ops, _t(X), _t(Y), _t(z), NWIN)
    assert S[0].shape == (NWIN, 2, 24, 1)
    want_S = jstraus.window_sums(_jops(False), X, Y, z, NWIN)  # (W, R, n, 1)
    for w in range(NWIN):
        for r in range(2):
            got = straus.projective_to_host(bls.G1, _np(_row(_row(S, w), r)))
            want = jstraus.projective_to_host(None, jbls.G1, _np(_row(_row(want_S, w), r)))
            assert _ints(got) == _ints(want), (w, r)
    joined = straus.horner_join(ops, S)
    direct = straus.msm_program(ops, _t(X), _t(Y), _t(z), NWIN)
    for r in range(2):
        host = _ints(_host_msm(bls.G1, pts[r], scal[r]))
        assert _ints(straus.projective_to_host(bls.G1, _np(_row(joined, r)))) == host
        assert _ints(straus.projective_to_host(bls.G1, _np(_row(direct, r)))) == host


def test_window_sums_without_a_row_axis():
    _, _, X, Y, z = _g1_case(32, 1, 64)
    ops = _ops(False)
    S = straus.window_sums(ops, _t(X[0]), _t(Y[0]), _t(z[0]), NWIN)
    R = straus.window_sums(ops, _t(X), _t(Y), _t(z), NWIN)
    assert S[0].shape == (NWIN, 24, 1)
    for a, b in zip(S, R):
        assert torch.equal(a, b[:, 0])


def test_msm_program_chunked_equals_the_reference():
    """256 lanes in 64-lane slices: the port's chunked MSM equals the JAX
    msm_program_chunked at the same max_lanes and the host MSM; the port's
    msm_program equals the JAX one on the first slice and the host MSM on
    all 256 lanes."""
    pts, scal, X, Y, z = _g1_case(33, 1, 256)
    X, Y, z = X[0], Y[0], z[0]
    ops, jops = _ops(False), _jops(False)
    chunked = straus.msm_program_chunked(ops, _t(X), _t(Y), _t(z), NWIN, max_lanes=64)
    jchunked = jstraus.msm_program_chunked(jops, X, Y, z, NWIN, max_lanes=64)
    host = _ints(_host_msm(bls.G1, pts[0], scal[0]))
    assert _ints(straus.projective_to_host(bls.G1, _np(chunked))) == host
    assert _ints(jstraus.projective_to_host(None, jbls.G1, jchunked)) == host
    whole = straus.msm_program(ops, _t(X), _t(Y), _t(z), NWIN)
    assert _ints(straus.projective_to_host(bls.G1, _np(whole))) == host
    sl = (slice(None), slice(0, 64))
    first = straus.msm_program(ops, _t(X[sl]), _t(Y[sl]), _t(z[sl]), NWIN)
    jfirst = jstraus.msm_program(jops, X[sl], Y[sl], z[sl], NWIN)  # the slices' program
    assert (_ints(straus.projective_to_host(bls.G1, _np(first)))
            == _ints(jstraus.projective_to_host(None, jbls.G1, jfirst))
            == _ints(_host_msm(bls.G1, pts[0][:64], scal[0][:64])))
    with pytest.raises(ValueError):
        straus.msm_program_chunked(ops, _t(X), _t(Y), _t(z), NWIN, max_lanes=96)


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_bool_msm_program_equals_the_reference(g2):
    """0/1 scalars over 16 lanes (three rows on G1): the masked lane
    reduction equals the JAX bool_msm_program and the host sum."""
    rng = random.Random(34 + g2)
    curve, gen = (bls.G2, bls.G2_GEN) if g2 else (bls.G1, bls.G1_GEN)
    rows = 1 if g2 else 3
    pts = [_points(curve, gen, 16, rng) for _ in range(rows)]
    mask = np.asarray([[rng.randrange(2) for _ in range(16)] for _ in range(rows)], np.uint32)
    mask[0, :2] = (1, 0)
    if g2:
        X, Y = _g2_planes(pts[0])
        mask = mask[0]
        jX, jY = X, Y
    else:
        planes = [_g1_planes(p) for p in pts]
        X = np.stack([p[0] for p in planes])
        Y = np.stack([p[1] for p in planes])
        jX, jY = X, Y
    got = straus.bool_msm_program(_ops(g2), _t(X), _t(Y), _t(mask))
    want = jstraus.bool_msm_program(_jops(g2), jX, jY, mask)
    for r in range(rows):
        m = mask if g2 else mask[r]
        g_r = _np(got) if g2 else _np(_row(got, r))
        w_r = _np(want) if g2 else _np(_row(want, r))
        host = None
        for bit, p in zip(m, pts[r]):
            host = curve.add(host, p if bit else None)
        assert _ints(straus.projective_to_host(curve, g_r)) == _ints(host)
        jcurve = jbls.G2 if g2 else jbls.G1
        assert _ints(jstraus.projective_to_host(None, jcurve, w_r)) == _ints(host)


def test_kzg_past_the_budget_equals_the_table_route_and_the_reference(monkeypatch):
    """kzg.setup(16) with a budget of 16 lanes (< D + 1 = 17): no table is
    built, commitments run msm_program in slices (8 coefficients each here)
    and equal the table route's and the JAX _msm_powers.  The default
    budget is the powers whose table fits the device's table budget."""
    pp = kzg.setup(16, curve="bls12_381", rng=frng.test_rng(), device="cpu")
    ops = prove_lm.sw_ops(groth16.pairing_config("bls12_381"), False, "cpu")
    assert kzg.uses_table(pp)
    assert pp.max_tab_lanes == straus.table_budget("cpu") // straus.table_bytes(ops, 1, 1)
    otf = dataclasses.replace(pp, max_tab_lanes=16)
    assert not kzg.uses_table(otf)
    assert kzg.setup(2, rng=frng.test_rng(), device="cpu", max_tab_lanes=2).max_tab_lanes == 2
    rng = random.Random(35)
    full = [rng.randrange(bls.R) for _ in range(12)]
    polys = [(full, None), ([5, 7, 11], 12)]
    monkeypatch.setattr(kzg, "MSM_CHUNK", 8)
    got = kzg.commit_many(otf, polys)  # full: 2 slices; the bounded one at powers 4..6
    assert otf.table is None
    table = kzg.commit_many(pp, polys, 8)
    assert [(c.c, c.shifted) for c in got] == [(c.c, c.shifted) for c in table]
    jpp = jkzg.setup(16, curve="bls12_381", rng=jrng.test_rng())
    assert _ints(got[1].shifted) == _ints(jkzg._msm_powers(jpp, [5, 7, 11], offset=4))
