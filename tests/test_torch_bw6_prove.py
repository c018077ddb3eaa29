"""The port's Groth16 provers over BW6-761 on the CPU, on the toy cube
circuit (M = 8; Fr of 24 limbs, 95 windows; Fq of 48 limbs for G1 and G2).

The limb-major prove_lm proof from the port's setup verifies under the
port's and the JAX package's verifiers, tampered proofs do not, and it
equals the port's v1 (batch-major) proof with the same keys and rng
state.  Under RUN_SLOW it also equals the JAX package's prove_lm and v1
proofs (the reference marks its own BW6-761 end to end slow,
tests/test_groth16.py).
"""

import os

import pytest
import torch

from zkmember_tpu.curves import bw6_761 as jbw6
from zkmember_tpu.r1cs import gadgets as jg
from zkmember_tpu.r1cs.cs import ConstraintSystem as JCS
from zkmember_tpu.snark import groth16 as jgroth16, prove_lm as jprove_lm
from zkmember_tpu.utils import rng as jrng
from zkmember_tpu.utils import serialize as jser
from zkmember_tpu_torch.curves import bw6_761 as bw6
from zkmember_tpu_torch.r1cs import gadgets as g
from zkmember_tpu_torch.r1cs.cs import ConstraintSystem
from zkmember_tpu_torch.snark import groth16, prove_lm
from zkmember_tpu_torch.utils import rng as frng
from zkmember_tpu_torch.utils import serialize as ser

PHASES = {"matrix_evals", "h_pipeline", "witness_planes", "g1_select_reduce", "g1_finish",
          "g2_select_reduce", "g2_finish", "fetch", "assemble"}


def cube_circuit(CS, gadgets, Fr, R):
    """tests/test_groth16.py's BW6-761 toy circuit: out = w^3 with w = 5."""
    cs = CS(Fr)
    out_val = pow(5, 3, R)
    out = gadgets.FpVar.new_input(cs, out_val)
    w = gadgets.FpVar.new_witness(cs, 5)
    (w * w * w).enforce_equal(out, "cube")
    return cs, out_val


def point_ints(pt):
    return [int(c.v) for c in pt]


@pytest.fixture(scope="module")
def proved():
    torch.set_num_threads(1)
    cs, out_val = cube_circuit(ConstraintSystem, g, bw6.Fr, bw6.R)
    rng = frng.test_rng()
    pk, vk = groth16.setup(cs, "bw6_761", rng, host=True)
    state = rng.getstate()
    keys = prove_lm.Groth16KeysLM(pk, "cpu")
    phases = {}
    proof = prove_lm.prove(keys, cs, rng=rng, phase_times=phases)
    return cs, out_val, pk, vk, keys, state, proof, phases


def test_prove_lm_proof_verifies_and_tampered_ones_do_not(proved):
    _, out_val, _, vk, keys, _, proof, phases = proved
    assert set(phases) == PHASES
    assert (keys.M, keys.B1, keys.B2g, keys.nwin) == (8, 64, 64, 95)
    assert keys.ops1.b3 == -3 and keys.ops2.b3 == 12
    assert groth16.verify(vk, [out_val], proof)
    assert not groth16.verify(vk, [(out_val + 1) % bw6.R], proof)
    neg_c = groth16.Proof(curve=proof.curve, a=proof.a, b=proof.b, c=bw6.G1.neg(proof.c))
    assert not groth16.verify(vk, [out_val], neg_c)
    jvk = jser.vk_from_bytes("bw6_761", ser.vk_to_bytes(vk))
    jproof = jser.proof_from_bytes("bw6_761", ser.proof_to_bytes(proof))
    assert jgroth16.verify(jvk, [out_val], jproof)
    assert not jgroth16.verify(jvk, [(out_val + 1) % jbw6.R], jproof)


def test_prove_lm_proof_equals_v1(proved):
    cs, _, pk, _, _, state, proof, _ = proved
    rng = frng.test_rng()
    rng.setstate(state)
    v1 = groth16.prove(pk, cs, rng=rng, device="cpu")
    assert (v1.a, v1.b, v1.c) == (proof.a, proof.b, proof.c)


@pytest.mark.skipif(not os.environ.get("RUN_SLOW"),
                    reason="the JAX BW6-761 provers take minutes on the CPU; RUN_SLOW=1")
def test_proofs_equal_reference(proved):
    _, _, _, _, _, _, proof, _ = proved
    jcs, _ = cube_circuit(JCS, jg, jbw6.Fr, jbw6.R)
    rng = jrng.test_rng()
    jpk, _ = jgroth16.setup(jcs, curve="bw6_761", rng=rng, host=True)
    state = rng.getstate()
    for prove in (lambda r: jprove_lm.prove(jprove_lm.Groth16KeysLM(jpk, jcs), jcs, rng=r),
                  lambda r: jgroth16.prove(jpk, jcs, rng=r)):
        r = jrng.test_rng()
        r.setstate(state)
        ref = prove(r)
        for got, want in ((proof.a, ref.a), (proof.b, ref.b), (proof.c, ref.c)):
            assert point_ints(got) == point_ints(want)
