"""The port's twisted-Edwards ops (curves.device te_*) against the JAX package's.

Both stacks' embedded curves: Jubjub over BLS12-381 Fr (16 limbs) and
Ed377 over BW6-761 Fr (24 limbs).  The same extended points, made from a
seeded numpy generator with a random Z (so no coordinate is trivially 1),
go through zkmember_tpu.curves.device on the CPU and through the port on
plain K3; every coordinate must match bit for bit.  The affine results
are also held against the host curve.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkmember_tpu.curves import device as jcdv
from zkmember_tpu.fields import device as jdv
from zkmember_tpu_torch.curves import device as cdv
from zkmember_tpu_torch.curves import ed377, jubjub
from zkmember_tpu_torch.fields import device as dv
from zkmember_tpu_torch.fields import spec as fs

B = 6
STACKS = {
    "jubjub": (jubjub.CURVE, fs.BLS_FR, jdv.BLS_FR),
    "ed377": (ed377.CURVE, fs.BW6_FR, jdv.BW6_FR),
}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


class Stack:
    def __init__(self, name):
        self.curve, self.spec, jspec = STACKS[name]
        self.F = dv.FpOps(self.spec, "cpu")
        self.JF = jdv.FpOps(jspec)
        a, d = self.spec.mont_scalar(self.curve.a.v), self.spec.mont_scalar(self.curve.d.v)
        self.C = cdv.TEConsts(a, d)
        self.JC = jcdv.TEConsts(a, d)
        self.rng = np.random.default_rng(sum(map(ord, name)))

    def affine(self, k):
        return [self.curve.mul(int(self.rng.integers(1, 1 << 62)), self.curve.generator)
                for _ in range(k)]

    def extended(self, pts):
        """(X, Y, T, Z) Montgomery limbs of affine points at a random Z."""
        p = self.spec.p
        zs = [int(self.rng.integers(1, 1 << 62)) for _ in pts]
        coords = [[q[0].v * z % p for q, z in zip(pts, zs)],
                  [q[1].v * z % p for q, z in zip(pts, zs)],
                  [q[0].v * q[1].v % p * z % p for q, z in zip(pts, zs)], zs]
        return tuple(self.spec.to_mont_host(c) for c in coords)

    def both(self, P):
        return (tuple(torch.as_tensor(c.astype(np.int32)) for c in P),
                tuple(jnp.asarray(c) for c in P))

    def assert_same(self, got, want):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy().astype(np.int64), np.asarray(w).astype(np.int64))

    def host_xy(self, P):
        """Affine ints of Montgomery (x, y) rows."""
        return list(zip(*(self.spec.from_mont_host(c.numpy()) for c in P)))


@pytest.fixture(scope="module", params=sorted(STACKS))
def stack(request):
    return Stack(request.param)


def test_te_identity(stack):
    got = cdv.te_identity(stack.F, (3,))
    stack.assert_same(got, jcdv.te_identity(stack.JF, (3,)))


def test_te_add_and_double_bit_exact(stack):
    pts, qts = stack.affine(B), stack.affine(B)
    (P, JP), (Q, JQ) = stack.both(stack.extended(pts)), stack.both(stack.extended(qts))
    S = cdv.te_add(stack.F, stack.C, P, Q)
    stack.assert_same(S, jax.jit(lambda P, Q: jcdv.te_add(stack.JF, stack.JC, P, Q))(JP, JQ))
    assert stack.host_xy(cdv.te_to_affine(stack.F, S)) == [
        (w[0].v, w[1].v) for w in map(stack.curve.add, pts, qts)]
    D = cdv.te_double(stack.F, stack.C, P)
    stack.assert_same(D, jax.jit(lambda P: jcdv.te_double(stack.JF, stack.JC, P))(JP))
    # the identity is absorbed
    I = cdv.te_add(stack.F, stack.C, P, cdv.te_identity(stack.F, (B,)))
    assert stack.host_xy(cdv.te_to_affine(stack.F, I)) == [(q[0].v, q[1].v) for q in pts]


def test_te_add_affine_const_and_cond_add(stack):
    pts = stack.affine(B)
    q = stack.affine(1)[0]
    P, JP = stack.both(stack.extended(pts))
    qx, qy = stack.spec.mont_scalar(q[0].v), stack.spec.mont_scalar(q[1].v)
    S = cdv.te_add_affine_const(stack.F, stack.C, P, qx, qy)
    stack.assert_same(S, jax.jit(
        lambda P: jcdv.te_add_affine_const(stack.JF, stack.JC, P, qx, qy))(JP))
    # a tensor constant gives the same rows as the numpy one
    stack.assert_same(cdv.te_add_affine_const(stack.F, stack.C, P, torch.as_tensor(
        qx.astype(np.int32)), torch.as_tensor(qy.astype(np.int32))), S)
    bit = np.array([1, 0, 1, 0, 1, 0][:B], np.uint32)
    C = cdv.te_cond_add_affine(stack.F, stack.C, P, qx, qy, torch.as_tensor(bit.astype(np.int32)))
    stack.assert_same(C, jax.jit(lambda P, b: jcdv.te_cond_add_affine(
        stack.JF, stack.JC, P, qx, qy, b))(JP, jnp.asarray(bit)))
    assert stack.host_xy(cdv.te_to_affine(stack.F, C)) == [
        ((stack.curve.add(p, q) if b else p)[0].v, (stack.curve.add(p, q) if b else p)[1].v)
        for p, b in zip(pts, bit)]


def test_te_scalar_mul_bit_exact(stack):
    nbits = 10
    pts = stack.affine(4)
    scalars = [int(stack.rng.integers(0, 1 << nbits)) for _ in range(2)] + [0, 1]
    bits = np.array([[(s >> (nbits - 1 - i)) & 1 for i in range(nbits)] for s in scalars],
                    np.uint32)  # MSB first
    P, JP = stack.both(stack.extended(pts))
    S = cdv.te_scalar_mul(stack.F, stack.C, torch.as_tensor(bits.astype(np.int32)), P)
    stack.assert_same(S, jax.jit(lambda b, P: jcdv.te_scalar_mul(
        stack.JF, stack.JC, b, P))(jnp.asarray(bits), JP))
    assert stack.host_xy(cdv.te_to_affine(stack.F, S)) == [
        (w[0].v, w[1].v) for w in (stack.curve.mul(s, p) for s, p in zip(scalars, pts))]


def test_te_to_affine_bit_exact(stack):
    P, JP = stack.both(stack.extended(stack.affine(B)))
    stack.assert_same(cdv.te_to_affine(stack.F, P),
                      jax.jit(lambda P: jcdv.te_to_affine(stack.JF, P))(JP))


def test_broadcast_const_expands_a_cached_row(stack):
    a = stack.F.broadcast_const(stack.C.a, (4, 3))
    assert a.shape == (4, 3, stack.spec.n) and a.stride()[:2] == (0, 0)
    assert np.array_equal(a[2, 1].numpy().astype(np.uint32), stack.C.a)
    assert stack.F.broadcast_const(stack.C.a, (2,)).data_ptr() == a.data_ptr()
