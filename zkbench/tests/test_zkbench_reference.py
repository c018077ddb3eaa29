"""The plain reference against the program on a toy circuit: every key
point and the proof equal, limb for limb after normalisation."""

import numpy as np

from reference import groth16_ref as R
from zkb import check as chk
from zkb.traffic import stream


def cube():
    from zkmember_tpu_torch.curves import bls12_381 as mod
    from zkmember_tpu_torch.r1cs import gadgets as g
    from zkmember_tpu_torch.r1cs.cs import ConstraintSystem

    cs = ConstraintSystem(mod.Fr)
    out = g.FpVar.new_input(cs, pow(11, 3, mod.R))
    w = g.FpVar.new_witness(cs, 11)
    (w * w * w).enforce_equal(out, "cube")
    return cs


def test_the_reference_gives_the_programs_key_and_proof():
    from zkmember_tpu_torch.snark import groth16, prove_lm

    curve = "bls12_381"
    cs = cube()
    pk, vk = groth16.setup(cs, curve, stream(2**31 + 5, "toxic_waste"), host=True)
    ref = R.Reference(curve, chk.toxic_waste(2**31 + 5, curve), cs.A, cs.B, cs.C,
                      cs.num_instance, cs.num_variables)
    assert ref.generators_ok() and ref.M == pk.domain_size
    key = chk.dump_key(pk, 3, 24)
    assert chk.key_wrong(ref, key) == 0
    assert all(len(q["points"]) == q["length"] for q in key["queries"].values())
    keys = prove_lm.Groth16KeysLM(pk, "cpu")
    proof = prove_lm.prove(keys, cs, rng=stream(2**31 + 5, "proofs"))
    pool = [(chk.assignment(ref, cs.values), [pow(11, 3, ref.r)])]
    records = [{"positions": [0], "proofs": [chk.proof_ints(proof)]}]
    assert chk.proofs_wrong(ref, pool, records, 2**31 + 5) == (0, 1)
    assert chk.proofs_wrong(ref, pool, records, 2**31 + 6) == (1, 1)
    assert chk.proofs_wrong(ref, pool, [{"positions": [0], "proofs": [None]}], 2**31 + 5) == (0, 0)
    assert groth16.verify(vk, cs.values[1:cs.num_instance], proof)


def test_a_wrong_key_point_or_witness_counts():
    cs = cube()
    ref = R.Reference("bls12_381", R.Toxic(3, 5, 7, 11, 13), cs.A, cs.B, cs.C, cs.num_instance,
                      cs.num_variables)
    nz = ref.nonzero()
    z = list(cs.values)
    assert ref.unsatisfied_rows(z) == 0
    z[-1] += 1
    assert ref.unsatisfied_rows(z) >= 1
    good = ref.key_point("h", 2, nz)
    assert good == ref.G1.mul(pow(13, 2, ref.r) * ref.z_tau * pow(11, -1, ref.r) % ref.r, ref.G1.gen)
    assert ref.G1.on_curve(good) and ref.G2.on_curve(ref.key_point("b_g2", 0, nz))


def test_montgomery_limbs_decode():
    q, n = R.curve_constants("bls12_381")["q"], 24
    x = 0x1234567890ABCDEF << 200
    m = x * (1 << (16 * n)) % q
    row = np.array([(m >> (16 * j)) & 0xFFFF for j in range(n)], np.int32)
    assert R.from_mont_limbs([row], q, n) == [x]


def test_the_pools_witnesses_and_the_circuits_sizes_are_held():
    cs = cube()
    ref = chk.reference_for(cs, "bls12_381", R.Toxic(3, 5, 7, 11, 13))
    out = pow(11, 3, ref.r)
    good = [(chk.assignment(ref, cs.values), [out]), (chk.assignment(ref, list(cs.values)), [out])]
    assert chk.witness_wrong(ref, good) == 0
    bad = list(cs.values)
    bad[-1] += 1
    assert chk.witness_wrong(ref, [good[0], (chk.assignment(ref, bad), [out])]) >= 1
    assert chk.publics_wrong(ref, good) == 0
    assert chk.witness_wrong(ref, [(z, [5]) for z, _ in good]) == 0
    assert chk.publics_wrong(ref, [(z, [5]) for z, _ in good]) == 2
    assert chk.publics_wrong(ref, [(good[0][0], [out, 1])]) == 1
    assert chk.assignment(ref, cs.values[:-1]) is None
    assert chk.witness_wrong(ref, [(None, [out])]) == 1
    sizes = {"constraints": ref.nc, "instance": 2, "variables": cs.num_variables, "domain_size": ref.M}
    assert chk.shape_wrong(ref, sizes) == 0
    assert chk.shape_wrong(ref, dict(sizes, constraints=ref.nc + 1, domain_size=2 * ref.M)) == 2
