"""The port's v1 (batch-major) Groth16 prover on the CPU.

On the toy cube circuit of tests/test_groth16.py, with keys from the port's
setup: the v1 proof verifies under the port's and the JAX package's
verifiers and a wrong input is rejected; it equals the port's limb-major
prove_lm proof on the same keys and rng state (which tests/test_torch_prove.py
holds against the JAX package).  Under RUN_SLOW it also equals the JAX
package's v1 groth16.prove, A, B and C (that prover takes minutes under
XLA on the CPU).
"""

import os

import pytest
import torch

from zkmember_tpu.curves import bls12_381 as jbls
from zkmember_tpu.r1cs import gadgets as jg
from zkmember_tpu.r1cs.cs import ConstraintSystem as JCS
from zkmember_tpu.snark import groth16 as jgroth16
from zkmember_tpu.utils import rng as jrng
from zkmember_tpu.utils import serialize as jser
from zkmember_tpu_torch.curves import bls12_381 as bls
from zkmember_tpu_torch.r1cs import gadgets as g
from zkmember_tpu_torch.r1cs.cs import ConstraintSystem
from zkmember_tpu_torch.snark import groth16, prove_lm
from zkmember_tpu_torch.utils import rng as frng
from zkmember_tpu_torch.utils import serialize as ser

PHASES = {"matrix_evals", "h_kernel", "h_to_host", "msm_a", "msm_b1", "msm_b2", "msm_h",
          "msm_l", "assemble"}


def cube_circuit(CS, gadgets, Fr, R):
    """tests/test_groth16.py's toy circuit: out = w^3 with w = 8."""
    cs = CS(Fr)
    out_val = pow(8, 3, R)
    out = gadgets.FpVar.new_input(cs, out_val)
    w = gadgets.FpVar.new_witness(cs, 8)
    (w * w * w).enforce_equal(out, "cube")
    return cs, out_val


def point_ints(pt):
    return [[int(c.v) for c in x.coeffs] if hasattr(x, "coeffs") else int(x.v) for x in pt]


@pytest.fixture(scope="module")
def proved():
    torch.set_num_threads(1)
    cs, out_val = cube_circuit(ConstraintSystem, g, bls.Fr, bls.R)
    rng = frng.test_rng()
    pk, vk = groth16.setup(cs, "bls12_381", rng, device="cpu")
    state = rng.getstate()
    phases = {}
    proof = groth16.prove(pk, cs, rng=rng, device="cpu", phase_times=phases)
    return cs, out_val, pk, vk, state, proof, phases


def test_v1_proof_verifies_under_both_verifiers(proved):
    cs, out_val, pk, vk, _, proof, phases = proved
    assert set(phases) == PHASES
    assert groth16.verify(vk, [out_val], proof)
    assert not groth16.verify(vk, [(out_val + 1) % bls.R], proof)
    neg_c = groth16.Proof(curve=proof.curve, a=proof.a, b=proof.b, c=bls.G1.neg(proof.c))
    assert not groth16.verify(vk, [out_val], neg_c)
    jvk = jser.vk_from_bytes("bls12_381", ser.vk_to_bytes(vk))
    jproof = jser.proof_from_bytes("bls12_381", ser.proof_to_bytes(proof))
    assert jgroth16.verify(jvk, [out_val], jproof)
    assert not jgroth16.verify(jvk, [(out_val + 1) % jbls.R], jproof)


def test_v1_proof_equals_prove_lm(proved):
    cs, _, pk, _, state, proof, _ = proved
    rng = frng.test_rng()
    rng.setstate(state)
    lm_proof = prove_lm.prove(prove_lm.Groth16KeysLM(pk, "cpu"), cs, rng=rng)
    assert (lm_proof.a, lm_proof.b, lm_proof.c) == (proof.a, proof.b, proof.c)


def test_prove_needs_a_card_unless_asked_for_the_cpu(proved, monkeypatch):
    cs, _, pk, _, _, _, _ = proved
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        groth16.prove(pk, cs, rng=frng.test_rng())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        groth16.setup(cs, "bls12_381", frng.test_rng())
    with pytest.raises(ValueError, match="unsupported curve"):
        groth16.pairing_config("bn254")


@pytest.mark.skipif(not os.environ.get("RUN_SLOW"),
                    reason="the JAX v1 prover takes minutes under XLA on the CPU; RUN_SLOW=1")
def test_v1_proof_equals_reference(proved):
    _, _, _, _, _, proof, _ = proved
    jcs, _ = cube_circuit(JCS, jg, jbls.Fr, jbls.R)
    rng = jrng.test_rng()
    jpk, _ = jgroth16.setup(jcs, curve="bls12_381", rng=rng, host=True)
    ref = jgroth16.prove(jpk, jcs, rng=rng)
    for got, want in ((proof.a, ref.a), (proof.b, ref.b), (proof.c, ref.c)):
        assert point_ints(got) == point_ints(want)
