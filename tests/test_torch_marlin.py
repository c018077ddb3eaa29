"""The port's Marlin (universal setup, index, prove, verify) against the JAX
package on the toy circuit of tests/test_marlin.py, on the CPU (plain K1,
K2, K3 and the finish).

Both packages draw the SRS and the prover's randomness from test_rng() in
the same order, so they must give an equal index (IndexInfo, entries,
matrix polynomials, matrix commitments) and an equal proof: every
commitment, sigma3, every evaluation and both opening witnesses.  Each
package's verifier accepts the other's proof; a wrong public input is
rejected; another rng gives other commitments (zero knowledge).  Under
RUN_SLOW a BW6-761 toy proof (a public input wider than 256 bits) is held
against the reference's as well.
"""

import os
import random

import pytest
import torch

from zkmember_tpu.curves import bls12_381 as jbls, bw6_761 as jbw6
from zkmember_tpu.r1cs import gadgets as jg
from zkmember_tpu.r1cs.cs import ConstraintSystem as JCS
from zkmember_tpu.snark import kzg as jkzg, marlin as jmarlin
from zkmember_tpu.utils import rng as jrng
from zkmember_tpu_torch.curves import bls12_381 as bls, bw6_761 as bw6
from zkmember_tpu_torch.r1cs import gadgets as g
from zkmember_tpu_torch.r1cs.cs import ConstraintSystem
from zkmember_tpu_torch.snark import kzg, marlin
from zkmember_tpu_torch.utils import rng as frng

NNZ = 8  # universal_setup's num_non_zero: the toy's |K|, SRS degree 48


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def toy_circuit(CS, gadgets, mod, witness_val: int):
    """Public out; private w: constraints (w+1)^2 = t, t * w = out."""
    cs = CS(mod.Fr)
    r = mod.R
    out_val = (witness_val + 1) ** 2 % r * witness_val % r
    out = gadgets.FpVar.new_input(cs, out_val)
    w = gadgets.FpVar.new_witness(cs, witness_val)
    w1 = w.add_constant(1)
    t = w1 * w1
    tw = t * w
    tw.enforce_equal(out, "out")
    return cs, out_val


def _pt(P):
    return None if P is None else (P[0].v, P[1].v)


def _comm(c):
    return (_pt(c.c), _pt(c.shifted), c.degree_bound)


def _proof_parts(proof):
    return {
        "comms": [_comm(c) for c in proof.comms1 + proof.comms2 + proof.comms3],
        "sigma3": proof.sigma3,
        "evals_beta1": proof.evals_beta1,
        "evals_beta2": proof.evals_beta2,
        "proof_beta1": _pt(proof.proof_beta1.w),
        "proof_beta2": _pt(proof.proof_beta2.w),
    }


def _as_commitment(c, kzg_mod, F):
    def pt(P):
        return None if P is None else (F(P[0].v), F(P[1].v))

    return kzg_mod.Commitment(c=pt(c.c), shifted=pt(c.shifted), degree_bound=c.degree_bound)


def _convert_proof(proof, marlin_mod, kzg_mod, F):
    """A MarlinProof of one package as the other package's types."""
    def comms(cs):
        return tuple(_as_commitment(c, kzg_mod, F) for c in cs)

    def opening(o):
        return kzg_mod.OpeningProof(w=None if o.w is None else (F(o.w[0].v), F(o.w[1].v)))

    return marlin_mod.MarlinProof(
        curve=proof.curve, comms1=comms(proof.comms1), comms2=comms(proof.comms2),
        comms3=comms(proof.comms3), sigma3=proof.sigma3,
        evals_beta1=dict(proof.evals_beta1), evals_beta2=dict(proof.evals_beta2),
        proof_beta1=opening(proof.proof_beta1), proof_beta2=opening(proof.proof_beta2))


def _both(curve, port_mod, jax_mod, witness_val, nnz, device="cpu"):
    """Setup, index and one proof in each package, both from test_rng()."""
    cs, out_val = toy_circuit(ConstraintSystem, g, port_mod, witness_val)
    jcs, _ = toy_circuit(JCS, jg, jax_mod, witness_val)
    assert cs.is_satisfied() and jcs.is_satisfied()
    rng = frng.test_rng()
    pp = marlin.universal_setup(cs.num_constraints, cs.num_variables, nnz, curve=curve, rng=rng,
                                device=device)
    ipk, ivk = marlin.index(pp, cs, device=device)
    phases: dict = {}
    proof = marlin.prove(ipk, cs, rng=rng, device=device, phase_times=phases)
    jrng_ = jrng.test_rng()
    jpp = jmarlin.universal_setup(jcs.num_constraints, jcs.num_variables, nnz, curve=curve,
                                  rng=jrng_)
    jipk, jivk = jmarlin.index(jpp, jcs)
    jproof = jmarlin.prove(jipk, jcs, rng=jrng_)
    return dict(cs=cs, out=out_val, pp=pp, ipk=ipk, ivk=ivk, proof=proof, phases=phases,
                jpp=jpp, jipk=jipk, jivk=jivk, jproof=jproof)


@pytest.fixture(scope="module")
def toy():
    return _both("bls12_381", bls, jbls, 7, NNZ)


def test_index_matches_reference(toy):
    ipk, jipk = toy["ipk"], toy["jipk"]
    assert vars(ipk.info) == vars(jipk.info)
    assert (ipk.info.n_h, ipk.info.n_k, ipk.info.n_x) == (8, 8, 2)
    assert ipk.entries == jipk.entries
    assert ipk.var_pos == jipk.var_pos
    assert {k: tuple(map(list, v)) for k, v in ipk.matrix_polys.items()} == \
        {k: tuple(map(list, v)) for k, v in jipk.matrix_polys.items()}
    for name in marlin.MATRICES:
        got = [_comm(c) for c in toy["ivk"].matrix_comms[name]]
        assert got == [_comm(c) for c in toy["jivk"].matrix_comms[name]]
        assert all(c[0] is not None for c in got)
    assert toy["pp"].max_degree == toy["jpp"].max_degree == \
        marlin.max_degree_bound(toy["cs"].num_constraints, toy["cs"].num_variables, NNZ) == 48


def test_proof_equals_reference_proof(toy):
    """The same rng state gives the same proof, part for part; every phase
    of the port's prover reported its time."""
    got, want = _proof_parts(toy["proof"]), _proof_parts(toy["jproof"])
    for key in want:
        assert got[key] == want[key], key
    assert set(toy["phases"]) == {"witness", "commit_round1", "outer_sumcheck",
                                  "commit_round2", "inner_sumcheck", "h2", "commit_round3",
                                  "open", "commit_open"}


@pytest.mark.parametrize("direction", ["port_proof_jax_verify", "jax_proof_port_verify"])
def test_proofs_verify_across_packages(toy, direction):
    out = toy["out"]
    if direction == "port_proof_jax_verify":
        proof = _convert_proof(toy["proof"], jmarlin, jkzg, jbls.Fq)
        assert jmarlin.verify(toy["jivk"], [out], proof)
        assert not jmarlin.verify(toy["jivk"], [(out + 1) % jbls.R], proof)
    else:
        proof = _convert_proof(toy["jproof"], marlin, kzg, bls.Fq)
        assert marlin.verify(toy["ivk"], [out], proof)
        assert not marlin.verify(toy["ivk"], [(out + 1) % bls.R], proof)


def test_verify_rejects_wrong_inputs_and_tampering(toy):
    ivk, proof, out = toy["ivk"], toy["proof"], toy["out"]
    assert marlin.verify(ivk, [out], proof)
    assert not marlin.verify(ivk, [(out + 1) % bls.R], proof)
    assert not marlin.verify(ivk, [out, 1], proof)  # wrong instance length
    bad = _convert_proof(proof, marlin, kzg, bls.Fq)
    bad.sigma3 = (bad.sigma3 + 1) % bls.R
    assert not marlin.verify(ivk, [out], bad)
    bad = _convert_proof(proof, marlin, kzg, bls.Fq)
    bad.evals_beta2["h_2"] = (bad.evals_beta2["h_2"] + 1) % bls.R
    assert not marlin.verify(ivk, [out], bad)


def test_universal_reuse_and_zero_knowledge(toy):
    """One SRS and index serve another witness of the same shape; another
    rng gives other witness commitments and evaluations (the reference's
    zk test), and both proofs verify."""
    cs2, out2 = toy_circuit(ConstraintSystem, g, bls, 11)
    p2 = marlin.prove(toy["ipk"], cs2, rng=random.Random(101), device="cpu")
    assert marlin.verify(toy["ivk"], [out2], p2)
    assert not marlin.verify(toy["ivk"], [toy["out"]], p2)
    p1 = toy["proof"]
    assert p1.comms1[0].c != p2.comms1[0].c, "w_hat commitment is deterministic"
    assert p1.comms1[1].c != p2.comms1[1].c, "z_A commitment is deterministic"
    assert p1.evals_beta1["w_hat"] != p2.evals_beta1["w_hat"]


def test_prove_rejects_a_witness_off_the_index(toy):
    """A constraint system whose instance disagrees with its witness does
    not fit the index: prove raises instead of making a bad proof."""
    cs, _ = toy_circuit(ConstraintSystem, g, bls, 7)
    cs.values[1] = (cs.values[1] + 1) % bls.R  # the public output
    with pytest.raises(ValueError):
        marlin.prove(toy["ipk"], cs, rng=random.Random(1), device="cpu")


@pytest.mark.skipif(not os.environ.get("RUN_SLOW"),
                    reason="the BW6-761 toy proof in both packages takes minutes; RUN_SLOW=1")
def test_bw6_toy_proof_equals_reference():
    """BW6-761 (Fr of 377 bits in 24 limbs, G1 over a 48-limb Fq): a public
    input wider than 256 bits (the field-width absorb), the equal proof,
    and verify both ways."""
    def bw6_circuit(CS, gadgets, mod):
        cs = CS(mod.Fr)
        big = (1 << 300) + 12345
        out_val = big * big % mod.R
        out = gadgets.FpVar.new_input(cs, out_val)
        w = gadgets.FpVar.new_witness(cs, big)
        (w * w).enforce_equal(out, "sq")
        return cs, out_val

    cs, out = bw6_circuit(ConstraintSystem, g, bw6)
    jcs, _ = bw6_circuit(JCS, jg, jbw6)
    rng = frng.test_rng()
    pp = marlin.universal_setup(cs.num_constraints, cs.num_variables, 16, curve="bw6_761",
                                rng=rng, device="cpu")
    ipk, ivk = marlin.index(pp, cs, device="cpu")
    proof = marlin.prove(ipk, cs, rng=rng, device="cpu")
    jrng_ = jrng.test_rng()
    jpp = jmarlin.universal_setup(jcs.num_constraints, jcs.num_variables, 16, curve="bw6_761",
                                  rng=jrng_)
    jipk, jivk = jmarlin.index(jpp, jcs)
    jproof = jmarlin.prove(jipk, jcs, rng=jrng_)
    assert _proof_parts(proof) == _proof_parts(jproof)
    assert marlin.verify(ivk, [out], proof)
    assert not marlin.verify(ivk, [(out + 1) % bw6.R], proof)
    assert jmarlin.verify(jivk, [out], _convert_proof(proof, jmarlin, jkzg, jbw6.Fq))
