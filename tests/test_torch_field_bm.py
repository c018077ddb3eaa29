"""The port's batch-major field ops against the JAX reference.

Same inputs (seeded random field elements, with the rows 0, 1 and p - 1,
as numpy (B, n) rows) go through zkmember_tpu.fields.device (its XLA
pipeline, and the Pallas kernel K3 through the interpreter, as
tests/test_pallas_field.py runs it) and through
zkmember_tpu_torch.fields.device on the CPU, where mont_mul takes the
plain version of the CUDA kernel.  Every result must match bit for bit:
both sides return the fully reduced representative.
"""

import os
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkmember_tpu.fields import device as jdv
from zkmember_tpu.fields import pallas_field
from zkmember_tpu_torch.fields import device as dv, field_cuda, spec as fs

PAIRS = {"BLS_FR": (jdv.BLS_FR, fs.BLS_FR), "BLS_FQ": (jdv.BLS_FQ, fs.BLS_FQ),
         "BW6_FQ": (jdv.BW6_FQ, fs.BW6_FQ)}
SLOW = pytest.mark.skipif(not os.environ.get("RUN_SLOW"), reason="RUN_SLOW=1 to run")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _vals(rng, p, B):
    v = [rng.randrange(p) for _ in range(B)]
    v[0], v[1], v[2] = 0, 1, p - 1
    return v


def _rows(spec, vals):
    """Values -> (numpy (B, n) uint32 Montgomery rows, matching torch int32)."""
    a = spec.to_mont_host(vals)
    return a, torch.from_numpy(a.astype(np.int32))


def _same(want, got):
    return np.array_equal(np.asarray(want).astype(np.int64), got.numpy().astype(np.int64))


def _operands(name, B=24, seed=1):
    ref, port = PAIRS[name]
    rng = random.Random(seed)
    a_np, a = _rows(port, _vals(rng, port.p, B))
    b_np, b = _rows(port, _vals(rng, port.p, B)[::-1])
    return ref, port, a_np, a, b_np, b


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_mont_mul_plain_matches_xla(name):
    ref, port, a_np, a, b_np, b = _operands(name)
    want = jdv.mont_mul(ref, jnp.asarray(a_np), jnp.asarray(b_np))
    assert _same(want, field_cuda.mont_mul_bm_plain(port, a, b))
    assert _same(want, dv.mont_mul(port, a, b))  # the CPU dispatch
    # a (n,) constant against (2, B/2, n) rows
    c_np = port.mont_scalar(123456789)
    want = jdv.mont_mul(ref, jnp.asarray(a_np.reshape(2, -1, port.n)), jnp.asarray(c_np))
    got = dv.mont_mul(port, a.reshape(2, -1, port.n), torch.from_numpy(c_np.astype(np.int32)))
    assert got.shape == (2, a.shape[0] // 2, port.n) and _same(want, got)


@pytest.mark.parametrize("name", ["BLS_FR", "BLS_FQ"])
def test_mont_mul_plain_matches_pallas_interpret(name):
    ref, port, a_np, a, b_np, b = _operands(name, B=8, seed=2)
    want = pallas_field.mont_mul(ref, jnp.asarray(a_np), jnp.asarray(b_np))
    assert _same(want, dv.mont_mul(port, a, b))
    c_np = port.mont_scalar(98765)
    want = pallas_field.mont_mul(ref, jnp.asarray(a_np), jnp.asarray(c_np))
    assert _same(want, dv.mont_mul(port, a, torch.from_numpy(c_np.astype(np.int32))))


@SLOW
def test_mont_mul_plain_matches_pallas_interpret_bw6():
    ref, port, a_np, a, b_np, b = _operands("BW6_FQ", B=8, seed=3)
    want = pallas_field.mont_mul(ref, jnp.asarray(a_np), jnp.asarray(b_np))
    assert _same(want, dv.mont_mul(port, a, b))


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_add_sub_neg_double_match_reference(name):
    ref, port, a_np, a, b_np, b = _operands(name, seed=4)
    A, B = jnp.asarray(a_np), jnp.asarray(b_np)
    assert _same(jdv.add(ref, A, B), dv.add(port, a, b))
    assert _same(jdv.sub(ref, A, B), dv.sub(port, a, b))
    assert _same(jdv.sub(ref, B, A), dv.sub(port, b, a))
    assert _same(jdv.neg(ref, A), dv.neg(port, a))
    assert _same(jdv.double(ref, A), dv.double(port, a))
    assert _same(jdv.to_mont(ref, A), dv.to_mont(port, a))
    assert _same(jdv.from_mont(ref, A), dv.from_mont(port, a))
    F = dv.FpOps(port, "cpu")
    assert np.array_equal(np.asarray(jdv.is_zero(ref, A)), F.is_zero(a).numpy())
    assert np.array_equal(np.asarray(jdv.eq(ref, A, A)), F.eq(a, a).numpy())


@pytest.mark.parametrize("name", ["BLS_FR", "BLS_FQ"])
def test_inv_matches_reference(name):
    ref, port, a_np, a, _, _ = _operands(name, B=4, seed=5)
    want = jdv.inv(ref, jnp.asarray(a_np))
    got = dv.inv(port, a)
    assert _same(want, got)
    assert (got[0] == 0).all()  # inv(0) = 0
    one = dv.mont_mul(port, a[1:], got[1:])
    assert (one == torch.from_numpy(port.one_mont.astype(np.int32))).all()


def test_stacked_ops_match_one_by_one():
    _, port, _, a, _, b = _operands("BLS_FQ", seed=6)
    F = dv.FpOps(port, "cpu")
    pairs = [(a, b), (b, a), (a, a)]
    assert all(torch.equal(x, F.mul(*p)) for x, p in zip(F.mul_many(pairs), pairs))
    assert all(torch.equal(x, F.add(*p)) for x, p in zip(F.add_many(pairs), pairs))
    assert all(torch.equal(x, F.sub(*p)) for x, p in zip(F.sub_many(pairs), pairs))
    three_a, m12_b = F.mul_consts([a, b], [3, -12])
    assert torch.equal(three_a, F.add(F.add(a, a), a))
    assert torch.equal(m12_b, F.neg(F.mul(b, F.const(12))))
    assert F.batch_shape(a) == (a.shape[0],)
    assert F.ones((2, 3)).shape == (2, 3, port.n)


def test_fp2_ops_match_reference():
    ref, port = jdv.BLS_FQ2, fs.BLS_FQ2
    rng = random.Random(7)
    B = 12
    vals = [[_vals(rng, port.base.p, B) for _ in range(2)] for _ in range(2)]
    (a0n, a0), (a1n, a1) = (_rows(port.base, v) for v in vals[0])
    (b0n, b0), (b1n, b1) = (_rows(port.base, v[::-1]) for v in vals[1])
    jF, F = jdv.Fp2Ops(ref), dv.Fp2Ops(port, "cpu")
    jA = (jnp.asarray(a0n), jnp.asarray(a1n))
    jB = (jnp.asarray(b0n), jnp.asarray(b1n))
    A, B_ = (a0, a1), (b0, b1)

    def same2(w, g):
        return _same(w[0], g[0]) and _same(w[1], g[1])

    assert same2(jF.mul(jA, jB), F.mul(A, B_))
    assert same2(jF.sqr(jA), F.sqr(A))
    assert same2(jF.add(jA, jB), F.add(A, B_))
    assert same2(jF.sub(jA, jB), F.sub(A, B_))
    for w, g in zip(jF.mul_many([(jA, jB), (jB, jA), (jA, jA)]),
                    F.mul_many([(A, B_), (B_, A), (A, A)])):
        assert same2(w, g)
    w, g = jF.inv(jA), F.inv(A)
    assert same2(w, g)
