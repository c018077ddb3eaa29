"""The port's Jacobian short-Weierstrass ops (curves.device sw_*) against the JAX package's.

BLS12-381 G1 over Fq (24 limbs) and, for the group law, G2 over Fq2.  The
same Jacobian points, made from a seeded numpy generator with a random Z
(so no coordinate is trivially 1), go through zkmember_tpu.curves.device
on the CPU and through the port on plain K3: the port keeps the
reference's formula order, so every coordinate must match limb for limb.
Affine results are also held against the host curve.  Then
``msm.scalars_to_bits_np`` and ``ntt._fft_core_axis`` on both axes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkmember_tpu import ntt as jntt
from zkmember_tpu.curves import device as jcdv
from zkmember_tpu.fields import device as jdv
from zkmember_tpu.msm import msm as jmsm
from zkmember_tpu_torch.curves import bls12_381 as bls
from zkmember_tpu_torch.curves import device as cdv
from zkmember_tpu_torch.fields import device as dv
from zkmember_tpu_torch.fields import spec as fs
from zkmember_tpu_torch.msm import msm
from zkmember_tpu_torch.ntt import ntt

NBITS = 12  # scalar width of the scalar multiplications: the loops are per bit
ADD_CASES = ["generic", "p_plus_p", "p_plus_neg_p", "p_inf", "q_inf", "both_inf"]
ROWS = 2  # rows of each addition case
_JITTED: dict = {}


def jx(fn, F, *args):
    """fn(F, *args) of the JAX package, jitted once per (fn, field) (op by
    op, one complete addition takes seconds on the CPU)."""
    key = (fn.__name__, type(F).__name__)
    if key not in _JITTED:
        _JITTED[key] = jax.jit(lambda *a: fn(F, *a))
    return _JITTED[key](*args)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


class Group:
    """One curve group on both stacks: host points as Jacobian limbs."""

    def __init__(self, g2: bool):
        self.g2 = g2
        self.curve, self.gen = (bls.G2, bls.G2_GEN) if g2 else (bls.G1, bls.G1_GEN)
        self.F = dv.Fp2Ops(fs.BLS_FQ2, "cpu") if g2 else dv.FpOps(fs.BLS_FQ, "cpu")
        self.JF = jdv.Fp2Ops(jdv.BLS_FQ2) if g2 else jdv.FpOps(jdv.BLS_FQ)
        self.rng = np.random.default_rng(5 if g2 else 4)
        self.p = fs.BLS_FQ.p

    def points(self, k):
        return [self.curve.mul(int(self.rng.integers(1, 1 << 62)), self.gen) for _ in range(k)]

    def _val(self, c):
        """A host coordinate as an int (Fq) or an (int, int) pair (Fq2)."""
        return tuple(int(x.v) for x in c.coeffs) if self.g2 else int(c.v)

    def _mul(self, a, b):
        p = self.p
        if not self.g2:
            return a * b % p
        return ((a[0] * b[0] - a[1] * b[1]) % p, (a[0] * b[1] + a[1] * b[0]) % p)

    def _rows(self, vals):
        if self.g2:
            return tuple(fs.BLS_FQ.to_mont_host([v[i] for v in vals]) for i in range(2))
        return fs.BLS_FQ.to_mont_host(vals)

    def jacobian(self, pts):
        """(X, Y, Z) Montgomery rows of points (None: infinity, (0, 1, 0)) at
        a random Z."""
        one, zero = ((1, 0), (0, 0)) if self.g2 else (1, 0)
        X, Y, Z = [], [], []
        for q in pts:
            if q is None:
                X.append(zero), Y.append(one), Z.append(zero)
                continue
            z = (tuple(int(v) for v in self.rng.integers(1, 1 << 62, 2)) if self.g2
                 else int(self.rng.integers(1, 1 << 62)))
            z2 = self._mul(z, z)
            X.append(self._mul(self._val(q[0]), z2))
            Y.append(self._mul(self._val(q[1]), self._mul(z2, z)))
            Z.append(z)
        return tuple(self._rows(c) for c in (X, Y, Z))

    def both(self, P):
        def t(c):
            if isinstance(c, tuple):
                return tuple(t(x) for x in c)
            return torch.as_tensor(np.asarray(c).astype(np.int32))

        def j(c):
            if isinstance(c, tuple):
                return tuple(j(x) for x in c)
            return jnp.asarray(c)

        return t(P), j(P)

    def assert_same(self, got, want):
        def flat(c):
            if isinstance(c, (tuple, list)):
                return [leaf for x in c for leaf in flat(x)]
            return [c]

        g, w = flat(got), flat(want)
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert np.array_equal(np.asarray(a).astype(np.int64), np.asarray(b).astype(np.int64))

    def affine(self, xyi):
        """Host points of the port's sw_to_affine output."""
        x, y, inf = xyi

        def ints(c):
            if isinstance(c, tuple):
                return list(zip(*(fs.BLS_FQ.from_mont_host(ci.numpy()) for ci in c)))
            return fs.BLS_FQ.from_mont_host(c.numpy())

        return [None if i else (a, b) for a, b, i in zip(ints(x), ints(y), inf.tolist())]

    def host(self, q):
        return None if q is None else (self._val(q[0]), self._val(q[1]))


@pytest.fixture(scope="module", params=[False, True], ids=["g1", "g2"])
def group(request):
    return Group(request.param)


@pytest.fixture(scope="module")
def g1():
    return Group(False)


def test_sw_infinity_and_neg(group):
    inf = cdv.sw_infinity(group.F, (3,))
    group.assert_same(inf, jcdv.sw_infinity(group.JF, (3,)))
    assert cdv.sw_is_infinity(group.F, inf).tolist() == [True] * 3
    P, JP = group.both(group.jacobian(group.points(2)))
    group.assert_same(cdv.sw_neg(group.F, P), jx(jcdv.sw_neg, group.JF, JP))


def test_sw_double(group):
    pts = group.points(3) + [None]
    P, JP = group.both(group.jacobian(pts))
    D = cdv.sw_double(group.F, P)
    group.assert_same(D, jx(jcdv.sw_double, group.JF, JP))
    want = [group.host(group.curve.add(q, q)) for q in pts]
    assert group.affine(cdv.sw_to_affine(group.F, D)) == want


@pytest.fixture(scope="module")
def adds(group):
    """Every addition case, ROWS rows each, in one batch through both
    stacks: (host P, host Q, port sums, JAX sums, port affine sums)."""
    pts, qts = [], []
    for case in ADD_CASES:
        p, q = group.points(ROWS), group.points(ROWS)
        if case == "p_plus_p":
            q = p
        elif case == "p_plus_neg_p":
            q = [group.curve.neg(x) for x in p]
        elif case in ("p_inf", "both_inf"):
            p = [None] * ROWS
        if case in ("q_inf", "both_inf"):
            q = [None] * ROWS
        pts += p
        qts += q
    P, JP = group.both(group.jacobian(pts))
    Q, JQ = group.both(group.jacobian(qts))
    S = cdv.sw_add(group.F, P, Q)
    return pts, qts, S, jx(jcdv.sw_add, group.JF, JP, JQ), group.affine(cdv.sw_to_affine(group.F, S))


@pytest.mark.parametrize("case", ADD_CASES)
def test_sw_add_cases(group, adds, case):
    pts, qts, S, JS, affine = adds
    rows = slice(ADD_CASES.index(case) * ROWS, (ADD_CASES.index(case) + 1) * ROWS)

    def pick(P):
        return tuple(cdv._map(lambda c: np.asarray(c)[rows], x) for x in P)

    group.assert_same(pick(S), pick(JS))
    want = [group.host(group.curve.add(a, b)) for a, b in zip(pts[rows], qts[rows])]
    assert affine[rows] == want


def test_sw_cond_add(g1):
    P, JP = g1.both(g1.jacobian(g1.points(4)))
    Q, JQ = g1.both(g1.jacobian(g1.points(4)))
    bits = np.array([1, 0, 1, 0], np.uint32)
    g1.assert_same(cdv.sw_cond_add(g1.F, P, Q, torch.as_tensor(bits.astype(np.int64))),
                   jx(jcdv.sw_cond_add, g1.JF, JP, JQ, jnp.asarray(bits)))


def test_sw_scalar_mul(g1):
    pts = g1.points(3) + [None]
    scalars = [int(v) for v in g1.rng.integers(0, 1 << NBITS, 4)]
    scalars[1] = 0
    bits = msm.scalars_to_bits_np(scalars, NBITS)
    P, JP = g1.both(g1.jacobian(pts))
    R = cdv.sw_scalar_mul(g1.F, bits, P)
    g1.assert_same(R, jx(jcdv.sw_scalar_mul, g1.JF, jnp.asarray(bits), JP))
    want = [g1.host(g1.curve.mul(s, q)) if q is not None else None for s, q in zip(scalars, pts)]
    assert g1.affine(cdv.sw_to_affine(g1.F, R)) == want


def test_sw_scalar_mul_windowed(g1):
    pts = g1.points(3)
    scalars = [int(v) for v in g1.rng.integers(0, 1 << NBITS, 3)]
    digits = np.array([[(s >> (4 * w)) & 15 for w in reversed(range(NBITS // 4))]
                       for s in scalars], np.uint32)
    P, JP = g1.both(g1.jacobian(pts))
    R = cdv.sw_scalar_mul_windowed(g1.F, digits, P)
    g1.assert_same(R, jx(jcdv.sw_scalar_mul_windowed, g1.JF, jnp.asarray(digits), JP))
    want = [g1.host(g1.curve.mul(s, q)) for s, q in zip(scalars, pts)]
    assert g1.affine(cdv.sw_to_affine(g1.F, R)) == want


def test_sw_to_affine(group):
    pts = group.points(3) + [None]
    P, JP = group.both(group.jacobian(pts))
    got = cdv.sw_to_affine(group.F, P)
    x, y, inf = jx(jcdv.sw_to_affine, group.JF, JP)
    group.assert_same(got[:2], (x, y))
    assert got[2].tolist() == np.asarray(inf).tolist()
    assert group.affine(got) == [group.host(q) for q in pts]


@pytest.mark.parametrize("B", [1, 3, 5, 8])
def test_sw_tree_reduce(g1, B):
    pts = g1.points(B)
    if B > 2:
        pts[1] = None
    P, JP = g1.both(g1.jacobian(pts))
    T = cdv.sw_tree_reduce(g1.F, P)
    g1.assert_same(T, jx(jcdv.sw_tree_reduce, g1.JF, JP))
    want = None
    for q in pts:
        want = g1.curve.add(want, q)
    lift = tuple(c[None] for c in T)
    assert g1.affine(cdv.sw_to_affine(g1.F, lift)) == [g1.host(want)]


def test_sw_msm_and_msm_bool(g1):
    pts = g1.points(5)
    scalars = [int(v) for v in g1.rng.integers(0, 1 << NBITS, 5)]
    bits = msm.scalars_to_bits_np(scalars, NBITS)
    P, JP = g1.both(g1.jacobian(pts))
    M = cdv.sw_msm(g1.F, bits, P)
    g1.assert_same(M, jx(jcdv.sw_msm, g1.JF, jnp.asarray(bits), JP))
    want = None
    for s, q in zip(scalars, pts):
        want = g1.curve.add(want, g1.curve.mul(s, q))
    assert g1.affine(cdv.sw_to_affine(g1.F, tuple(c[None] for c in M))) == [g1.host(want)]
    mask = np.array([1, 0, 1, 1, 0], np.uint32)
    Mb = cdv.sw_msm_bool(g1.F, mask, P)
    g1.assert_same(Mb, jx(jcdv.sw_msm_bool, g1.JF, jnp.asarray(mask), JP))


def test_scalars_to_bits_np():
    rng = np.random.default_rng(9)
    scalars = [int(rng.integers(0, 1 << 62)) << 190 | int(rng.integers(0, 1 << 62))
               for _ in range(5)] + [0, bls.R - 1]
    got = msm.scalars_to_bits_np(scalars, 255)
    want = jmsm.scalars_to_bits_np(scalars, 255)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert [int("".join(map(str, row)), 2) for row in got] == scalars


@pytest.mark.parametrize("axis", [0, 1, -2])
@pytest.mark.parametrize("inverse", [False, True])
def test_fft_core_axis(axis, inverse):
    spec, jspec = fs.BLS_FR, jdv.BLS_FR
    rng = np.random.default_rng(11)
    N1, N2 = 8, 16
    vals = [int(rng.integers(0, 1 << 62)) for _ in range(N1 * N2)]
    x = spec.to_mont_host(vals).reshape(N1, N2, spec.n)
    size = x.shape[axis]
    got = ntt._fft_core_axis(ntt.Domain.get(spec, size), torch.as_tensor(x.astype(np.int32)),
                             axis, inverse)
    want = jntt._fft_core_axis(jntt.Domain.get(jspec, size), jnp.asarray(x), axis, inverse)
    assert np.array_equal(got.numpy().astype(np.int64), np.asarray(want).astype(np.int64))
