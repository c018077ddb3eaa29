"""prove_lm's key options against the JAX package, on the toy cube circuit:
``precompute=False`` (each MSM builds its table on the fly), the table
budget (``straus.table_budget``), ``merge_bool=False`` (the boolean
witness class in its own masked lane reductions) and ``min_lanes``.

The JAX package builds the key (groth16.setup, host=True); the port gets
it as plain arrays (prove_lm.keys_from_numpy).  Both provers draw r and s
from utils.rng.test_rng(7), so A, B and C must be equal as affine points.
"""

import numpy as np
import pytest
import torch

from zkmember_tpu.curves import bls12_381 as jbls
from zkmember_tpu.r1cs import gadgets as jg
from zkmember_tpu.r1cs.cs import ConstraintSystem as JCS
from zkmember_tpu.snark import groth16 as jgroth16, prove_lm as jprove_lm
from zkmember_tpu.utils import rng as jrng
from zkmember_tpu_torch.curves import bls12_381 as bls
from zkmember_tpu_torch.msm import straus
from zkmember_tpu_torch.r1cs import gadgets as g
from zkmember_tpu_torch.r1cs.cs import ConstraintSystem
from zkmember_tpu_torch.snark import groth16, prove_lm
from zkmember_tpu_torch.utils import rng as frng

from test_torch_prove import cube_circuit, key_as_numpy, point_ints

# The port floors B2g at K1's 64 lanes; the JAX key reaches it through its pin.
JAX_B2G = dict(min_g2_lanes=prove_lm.MIN_LANES)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def toy():
    """The cube circuit in both packages (one boolean witness), its JAX key,
    and the port's default key from the same arrays."""
    jcs, out_val = cube_circuit(JCS, jg, jbls.Fr, jbls.R)
    cs, _ = cube_circuit(ConstraintSystem, g, bls.Fr, bls.R)
    assert cs.boolean_vars == jcs.boolean_vars and cs.boolean_vars
    pk, vk = jgroth16.setup(jcs, curve="bls12_381", rng=jrng.test_rng(), host=True)
    planes, meta = key_as_numpy(pk, vk)
    keys = prove_lm.keys_from_numpy(planes, device="cpu", **meta)
    return jcs, cs, out_val, pk, keys


def _points(proof):
    return [point_ints(p) for p in (proof.a, proof.b, proof.c)]


def test_options_key_and_proof_equal_the_reference(toy):
    """precompute=False, merge_bool=False with min_lanes: the lane counts,
    class columns and table gates equal the JAX key's; the proof equals the
    JAX prover's and the port's table-route proof, and verifies."""
    jcs, cs, out_val, pk, base = toy
    opts = dict(precompute=False, merge_bool=False, min_lanes=4)
    keys = prove_lm.Groth16KeysLM(base.pk, "cpu", cs=cs, **opts)
    jkeys = jprove_lm.Groth16KeysLM(pk, jcs, **opts, **JAX_B2G)
    assert (keys.Bb, keys.B2g, keys.B2b) == (jkeys.Bb, jkeys.B2g, jkeys.B2b) == (4, 64, 4)
    assert keys.has_bool and jkeys.has_bool
    for got, want in zip(keys.bool_cols + keys.gen_cols + [keys.b_cols, keys.b_bool_cols],
                         jkeys.bool_cols + jkeys.gen_cols
                         + [jkeys.b_gen_cols, jkeys.b_bool_cols]):
        assert np.array_equal(got, want)
    assert (keys._want_g1_tab, keys._want_g2_tab) == (False, False)
    assert keys.g1_tab is None and keys.g2_tab is None

    phases = {}
    proof = prove_lm.prove(keys, cs, rng=frng.test_rng(7), phase_times=phases)
    assert {"g1_table", "g2_table", "g1_bool", "g2_bool"} <= set(phases)
    ref = jprove_lm.prove(jkeys, jcs, rng=jrng.test_rng(7))
    table = prove_lm.prove(base, cs, rng=frng.test_rng(7))
    assert _points(proof) == _points(ref) == _points(table)
    vk = base.pk.vk
    assert groth16.verify(vk, [out_val], proof)
    assert not groth16.verify(vk, [(out_val + 1) % bls.R], proof)
    bad = groth16.Proof(curve=proof.curve, a=proof.a, b=proof.b, c=bls.G1.neg(proof.c))
    assert not groth16.verify(vk, [out_val], bad)


def test_merged_keys_match_the_reference_lanes(toy):
    """Default options: the boolean class stays in the general lanes, so the
    key has no boolean planes; B2g is the JAX key's at K1's floor, and
    min_lanes reaches it as in the JAX key."""
    jcs, cs, _, pk, base = toy
    keys = prove_lm.Groth16KeysLM(base.pk, "cpu")
    jkeys = jprove_lm.Groth16KeysLM(pk, jcs, **JAX_B2G)
    assert not keys.has_bool and not jkeys.has_bool
    assert keys.B2g == jkeys.B2g == prove_lm.MIN_LANES
    for got, want in zip(keys.gen_cols, jkeys.gen_cols):
        assert np.array_equal(got, want)
    assert keys.B1 == max(pk.domain_size, prove_lm.MIN_LANES)
    wide = prove_lm.Groth16KeysLM(base.pk, "cpu", min_lanes=128)
    assert wide.B2g == jprove_lm.Groth16KeysLM(pk, jcs, min_lanes=128).B2g == 128
    assert wide.B1 == 128


def test_merge_bool_false_needs_the_circuit(toy):
    _, _, _, _, base = toy
    with pytest.raises(ValueError, match="cs="):
        prove_lm.Groth16KeysLM(base.pk, "cpu", merge_bool=False)


def test_prove_batch_refuses_keys_without_tables_or_with_a_boolean_class(toy, monkeypatch):
    _, cs, _, _, base = toy
    keys = [prove_lm.Groth16KeysLM(base.pk, "cpu", **kw)
            for kw in (dict(precompute=False), dict(cs=cs, merge_bool=False))]
    monkeypatch.setattr(straus, "table_budget", lambda device: 0)
    keys.append(prove_lm.Groth16KeysLM(base.pk, "cpu"))  # past the budget
    for k in keys:
        with pytest.raises(ValueError, match="prove_batch"):
            prove_lm.prove_batch(k, [cs, cs], rng=frng.test_rng(7))


def test_table_gates_follow_the_lane_budget(toy, monkeypatch):
    """G1 keeps its table while its bytes fit the device's table budget, G2
    while its bytes fit what G1 leaves; a key builds only the tables it
    keeps.  The default budget (an eighth of the host's memory here) keeps
    both of the toy key's."""
    _, _, _, _, base = toy
    g1 = straus.table_bytes(base.ops1, 4, base.B1)
    g2 = straus.table_bytes(base.ops2, 1, base.B2g)
    assert (g1, g2) == (16 * 4 * base.B1 * 3 * 24 * 2, 16 * base.B2g * 6 * 24 * 2)
    assert (base._want_g1_tab, base._want_g2_tab) == (True, True)
    assert straus.table_budget("cpu") >= g1 + g2
    for budget, want in ((g1 + g2, (True, True)), (g1 + g2 - 1, (True, False)),
                         (g1 - 1, (False, True)), (g2 - 1, (False, False))):
        monkeypatch.setattr(straus, "table_budget", lambda device, b=budget: b)
        keys = prove_lm.Groth16KeysLM(base.pk, "cpu")
        assert (keys._want_g1_tab, keys._want_g2_tab) == want, budget
    monkeypatch.setattr(straus, "table_budget", lambda device: g1 + g2 - 1)
    keys = prove_lm.Groth16KeysLM(base.pk, "cpu")
    prove_lm.warm(keys)
    assert keys._g1_tab is not None and keys._g2_tab is None
