"""The port's batched proving against the JAX package: kernel K1's proof-batch
axis (plain version), the batched H pipeline, the batched Straus MSM and
``prove_lm.prove_batch``.

Inputs come from seeded random.Random / numpy; the JAX side runs the
reference's XLA composition (``straus.window_sums``, ``ntt.lm.groth16_h_batch``)
and its prover.  Field planes must match bit for bit, points after
normalisation.
"""

import os
import random

import numpy as np
import pytest
import torch

from zkmember_tpu.curves import bls12_381 as jbls, device as jcdv
from zkmember_tpu.fields import device as dv, lm as jlm
from zkmember_tpu.msm import straus as jstraus
from zkmember_tpu.ntt import lm as jnttlm
from zkmember_tpu.r1cs import gadgets as jg
from zkmember_tpu.r1cs.cs import ConstraintSystem as JCS
from zkmember_tpu.snark import groth16 as jgroth16, prove_lm as jprove_lm
from zkmember_tpu.utils import rng as jrng
from zkmember_tpu_torch.curves import bls12_381 as bls
from zkmember_tpu_torch.fields import spec as fs
from zkmember_tpu_torch.msm import select_reduce_cuda as k1, straus
from zkmember_tpu_torch.ntt import lm as nttlm
from zkmember_tpu_torch.r1cs import gadgets as g
from zkmember_tpu_torch.r1cs.cs import ConstraintSystem
from zkmember_tpu_torch.snark import groth16, prove_lm
from zkmember_tpu_torch.utils import rng as frng

from test_torch_prove import cube_circuit, key_as_numpy, point_ints


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int32))


def _map(f, c):
    return tuple(_map(f, ci) for ci in c) if isinstance(c, tuple) else f(c)


def _flat(S):
    return [c for x in S for c in (_flat(x) if isinstance(x, tuple) else [x])]


def _point_ints(pt):
    return None if pt is None else point_ints(pt)


def _curve(g2):
    return (bls.G2, bls.G2_GEN, jbls.G2) if g2 else (bls.G1, bls.G1_GEN, jbls.G1)


def _points_planes(g2, B, R, seed):
    """R rows of B random points as limb-major Montgomery planes (numpy),
    coordinates as (c0, c1) pairs for G2."""
    curve, gen, _ = _curve(g2)
    rng = random.Random(seed)
    pts = [[curve.mul(rng.randrange(1, bls.R), gen) for _ in range(B)] for _ in range(R)]

    def plane(coord, comp):
        def val(p):
            x = p[coord]
            return x.coeffs[comp].v if g2 else x.v

        return np.ascontiguousarray(np.stack(
            [fs.to_lm(fs.BLS_FQ.to_mont_host([val(p) for p in row])) for row in pts]))

    if g2:
        return (plane(0, 0), plane(0, 1)), (plane(1, 0), plane(1, 1))
    return plane(0, 0), plane(1, 0)


def _scalars(P, R, B, bits, seed):
    rng = random.Random(seed)
    vals = [[[rng.randrange(1 << bits) for _ in range(B)] for _ in range(R)] for _ in range(P)]
    return np.stack([np.stack([fs.to_lm(fs.ints_to_limbs(v, 16)) for v in rows]) for rows in vals])


def _ops(g2):
    return prove_lm.sw_ops(groth16.pairing_config("bls12_381"), g2, "cpu")


def _jops(g2):
    if g2:
        return jcdv.sw_ops_for(jlm.Fp2OpsLM(dv.BLS_FQ2), (12, 12), "bls12_381_g2/lm")
    return jcdv.sw_ops_for(jlm.FpOpsLM(dv.BLS_FQ), 12, "bls12_381_g1/lm")


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_select_reduce_plain_proof_axis(g2):
    """Digits (W, P, R, B) against one table: proof p's window sums equal a
    3-D call on its digits limb for limb, and, reduced over the lanes, the
    reference's XLA window sums of its scalars, per row."""
    nwin, P, R, B = 4, 3, 2, 16
    X, Y = _points_planes(g2, B, R, 31 + g2)
    z = _scalars(P, R, B, 16, 41 + g2)  # (P, R, n, B)
    ops = _ops(g2)
    tab = straus.table_program(ops, _map(_t, X), _map(_t, Y))  # (16, R, B, .)
    digits = straus.digits_from_limbs(_t(z), nwin).contiguous()  # (W, P, R, B)
    assert digits.shape == (nwin, P, R, B)
    S = k1.select_reduce_plain(ops, tab, digits)
    NT = B // k1.tile_shape(B)[1]
    assert all(c.shape == (nwin, P, R, 24, NT) for c in _flat(S))
    for p in range(P):
        one = k1.select_reduce_plain(ops, tab, digits[:, p].contiguous())
        assert all(torch.equal(a[:, p], b) for a, b in zip(_flat(S), _flat(one)))
    # the reference's window sums of every (proof, row) in one call: the
    # points broadcast over the proofs
    mine = straus.tree_reduce_lanes(ops, S)  # (W, P, R, n, 1)
    want = jstraus.window_sums(_jops(g2), _map(lambda c: np.broadcast_to(c, (P,) + c.shape), X),
                               _map(lambda c: np.broadcast_to(c, (P,) + c.shape), Y), z, nwin)
    curve, jcurve = _curve(g2)[0], _curve(g2)[2]
    for p in range(P):
        for r in range(R):
            for w in range(nwin):
                got_w = straus.projective_to_host(
                    curve, tuple(_map(lambda c: c[w, p, r].numpy(), x) for x in mine))
                want_w = jstraus.projective_to_host(
                    None, jcurve, tuple(_map(lambda c: np.asarray(c[w, p, r]), x) for x in want))
                assert _point_ints(got_w) == _point_ints(want_w), (p, r, w)


def test_groth16_h_batch_bit_exact():
    rng = random.Random(17)
    N, P = 64, 3
    p = fs.BLS_FR.p
    stacks = []
    for _ in range(P):
        a = [rng.randrange(p) for _ in range(N)]
        b = [rng.randrange(p) for _ in range(N)]
        c = [x * y % p for x, y in zip(a, b)]
        stacks.append(np.stack([dv.BLS_FR.to_mont_host(v).T for v in (a, b, c)]))
    dabc = np.ascontiguousarray(np.stack(stacks))  # (P, 3, n, N)
    want = np.asarray(jnttlm.groth16_h_batch(jnttlm.DomainLM.get(dv.BLS_FR, N), dabc))
    dlm = nttlm.DomainLM.get(fs.BLS_FR, N, "cpu")
    got = nttlm.groth16_h_batch(dlm, _t(dabc))
    assert got.shape == (P, 16, N)
    assert np.array_equal(want.astype(np.int64), got.numpy().astype(np.int64))
    one = nttlm.groth16_h(dlm, *_t(dabc[1]).unbind(0))
    assert torch.equal(got[1], one)


@pytest.mark.parametrize("g2", [False, True], ids=["g1_rows", "g2"])
def test_msm_precomp_batch_equals_single_msms(g2):
    """P MSMs over one table equal P calls of msm_precomp_program: G1 with a
    row axis (P, R, n, B), G2 without one (P, n, B)."""
    nwin, P, B = 8, 2, 16
    R = 1 if g2 else 2
    X, Y = _points_planes(g2, B, R, 51 + g2)
    ops = _ops(g2)
    z = _scalars(P, R, B, 32, 61 + g2)  # (P, R, n, B)
    if g2:  # no row axis
        X, Y, z = _map(lambda c: c[0], X), _map(lambda c: c[0], Y), z[:, 0]
    tab = straus.table_program(ops, _map(_t, X), _map(_t, Y))
    phases = []
    out = straus.msm_precomp_batch(ops, tab, nwin, _t(z), phases.append, "x_")
    assert phases == ["x_select_reduce", "x_finish"]
    lead = (P,) if g2 else (P, R)
    assert all(c.shape == lead + (24, 1) for c in _flat(out))
    curve = _curve(g2)[0]
    for p in range(P):
        single = straus.msm_precomp_program(ops, tab, nwin, _t(z[p]))
        for r in range(1 if g2 else R):
            def pick(S, *idx):
                return tuple(_map(lambda c: c[idx].numpy(), x) for x in S)

            got = straus.projective_to_host(curve, pick(out, p) if g2 else pick(out, p, r))
            want = straus.projective_to_host(curve, pick(single) if g2 else pick(single, r))
            assert got is not None and _point_ints(got) == _point_ints(want), (p, r)


WITNESSES = (8, 3)


@pytest.fixture(scope="module")
def cube_batch():
    """The JAX key of the cube circuit, the port's keys from it, both
    packages' circuits for each witness, and the JAX proofs: prove_lm.prove
    called once per witness, in order, from one test_rng(7)."""
    jcs = [cube_circuit(JCS, jg, jbls.Fr, jbls.R, w) for w in WITNESSES]
    pcs = [cube_circuit(ConstraintSystem, g, bls.Fr, bls.R, w) for w in WITNESSES]
    pk, vk = jgroth16.setup(jcs[0][0], curve="bls12_381", rng=jrng.test_rng(), host=True)
    planes, meta = key_as_numpy(pk, vk)
    keys = prove_lm.keys_from_numpy(planes, device="cpu", **meta)
    jkeys = jprove_lm.Groth16KeysLM(pk, jcs[0][0])
    rng = jrng.test_rng(7)
    ref = [jprove_lm.prove(jkeys, cs, rng=rng) for cs, _ in jcs]
    return keys, pcs, ref, (pk, vk, jkeys, jcs)


def test_prove_batch_equals_reference_proofs_and_verifies(cube_batch):
    keys, pcs, ref, _ = cube_batch
    assert all(cs.is_satisfied() for cs, _ in pcs)
    phases = {}
    proofs = prove_lm.prove_batch(keys, [cs for cs, _ in pcs], rng=frng.test_rng(7),
                                  phase_times=phases)
    assert set(phases) == {
        "matrix_evals", "h_pipeline", "witness_planes", "g1_select_reduce", "g1_finish",
        "g2_select_reduce", "g2_finish", "fetch", "assemble",
    }
    assert len(proofs) == len(WITNESSES)
    vk = keys.pk.vk
    for proof, want, (_, out_val) in zip(proofs, ref, pcs):
        for got_pt, want_pt in ((proof.a, want.a), (proof.b, want.b), (proof.c, want.c)):
            assert _point_ints(got_pt) == _point_ints(want_pt)
        assert groth16.verify(vk, [out_val], proof)
    # each proof is bound to its own public input: swapped, both fail
    (_, v0), (_, v1) = pcs
    assert v0 != v1
    assert not groth16.verify(vk, [v1], proofs[0])
    assert not groth16.verify(vk, [v0], proofs[1])


def test_prove_batch_rejects_an_empty_batch(cube_batch):
    keys = cube_batch[0]
    with pytest.raises(ValueError):
        prove_lm.prove_batch(keys, [], rng=frng.test_rng(7))


@pytest.mark.skipif(
    not os.environ.get("RUN_SLOW"),
    reason="the reference's batched interpret-mode Pallas prover takes about 25 min on "
    "the CPU (tests/test_prove_lm.py); RUN_SLOW=1",
)
def test_prove_batch_equals_reference_prove_batch(cube_batch, monkeypatch):
    """The reference's prove_batch needs its Pallas tables: as its own test
    does, an 8-lane kernel tile and G2 lanes (interpret mode on the CPU)."""
    keys, pcs, _, (pk, vk, _, jcs) = cube_batch
    monkeypatch.setenv("ZKMEMBER_PALLAS_MSM_TILE", "8")
    jkeys = jprove_lm.Groth16KeysLM(pk, jcs[0][0], min_g2_lanes=8)
    assert jkeys.g1_tab is not None and jkeys.g2_tab is not None
    proofs = prove_lm.prove_batch(keys, [cs for cs, _ in pcs], rng=frng.test_rng(9))
    ref = jprove_lm.prove_batch(jkeys, [cs for cs, _ in jcs], rng=jrng.test_rng(9))
    for proof, want in zip(proofs, ref):
        for got_pt, want_pt in ((proof.a, want.a), (proof.b, want.b), (proof.c, want.c)):
            assert _point_ints(got_pt) == _point_ints(want_pt)
