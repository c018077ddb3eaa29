"""The port's Groth16 setup and key checkpoints against the JAX reference.

On the toy cube circuit of tests/test_groth16.py the port's device setup
(fixed-base multiplications through the batch-major stack, on the CPU) and
the JAX package's setup(host=True) draw the same toxic waste from
utils.rng.test_rng() and must give the same key: equal query planes, index
lists, points and verifying-key bytes.  Keys the port saves load in the
JAX package.  The host half of the 16-member setup reproduces the
committed key's beta and delta.
"""

import json
import os

import numpy as np
import pytest
import torch

from zkmember_tpu.curves import bls12_381 as jbls
from zkmember_tpu.r1cs import gadgets as jg
from zkmember_tpu.r1cs.cs import ConstraintSystem as JCS
from zkmember_tpu.snark import groth16 as jgroth16
from zkmember_tpu.utils import checkpoint as jcheckpoint
from zkmember_tpu.utils import rng as jrng
from zkmember_tpu.utils import serialize as jser
from zkmember_tpu_torch.curves import bls12_381 as bls
from zkmember_tpu_torch.r1cs import gadgets as g
from zkmember_tpu_torch.r1cs.cs import ConstraintSystem
from zkmember_tpu_torch.snark import groth16
from zkmember_tpu_torch.utils import checkpoint
from zkmember_tpu_torch.utils import rng as frng
from zkmember_tpu_torch.utils import serialize as ser

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUERIES = ("a_query", "b_g1_query", "b_g2_query", "h_query", "l_query")


def cube_circuit(CS, gadgets, Fr, R):
    """tests/test_groth16.py's toy circuit: out = w^3 with w = 8."""
    cs = CS(Fr)
    out_val = pow(8, 3, R)
    out = gadgets.FpVar.new_input(cs, out_val)
    w = gadgets.FpVar.new_witness(cs, 8)
    (w * w * w).enforce_equal(out, "cube")
    return cs, out_val


def planes(pa):
    """A query's planes as {"x": ..., "y": ... (_c0/_c1 for Fp2)} uint32 numpy."""
    out = {}
    for name, c in (("x", pa.x), ("y", pa.y)):
        for i, ci in enumerate(c if isinstance(c, tuple) else (c,)):
            arr = ci.numpy() if isinstance(ci, torch.Tensor) else np.asarray(ci)
            out[f"{name}{i if isinstance(c, tuple) else ''}"] = arr.astype(np.uint32)
    return out


def point_ints(pt):
    return [[int(c.v) for c in x.coeffs] if hasattr(x, "coeffs") else int(x.v) for x in pt]


@pytest.fixture(scope="module")
def keys():
    torch.set_num_threads(1)
    jcs, _ = cube_circuit(JCS, jg, jbls.Fr, jbls.R)
    cs, _ = cube_circuit(ConstraintSystem, g, bls.Fr, bls.R)
    jpk, jvk = jgroth16.setup(jcs, curve="bls12_381", rng=jrng.test_rng(), host=True)
    phases = {}
    pk, vk = groth16.setup(cs, "bls12_381", frng.test_rng(), device="cpu", phase_times=phases)
    return jpk, jvk, pk, vk, phases


def test_device_setup_equals_reference(keys):
    jpk, jvk, pk, vk, phases = keys
    assert set(phases) == {"qap", "fixed_base_tables", "gamma_abc", "a_query", "b_g1_query",
                           "b_g2_query", "h_query", "l_query", "vk"}
    for q in QUERIES:
        want, got = planes(getattr(jpk, q)), planes(getattr(pk, q))
        assert sorted(want) == sorted(got), q
        for k in want:
            assert np.array_equal(want[k], got[k]), (q, k)
    for attr in ("a_nonzero", "b_nonzero", "l_nonzero", "domain_size", "num_instance"):
        assert getattr(jpk, attr) == getattr(pk, attr), attr
    assert point_ints(jpk.beta_g1) == point_ints(pk.beta_g1)
    assert point_ints(jpk.delta_g1) == point_ints(pk.delta_g1)
    assert jser.vk_to_bytes(jvk) == ser.vk_to_bytes(vk)


def test_host_setup_equals_device_setup(keys):
    _, _, pk, vk, _ = keys
    cs, _ = cube_circuit(ConstraintSystem, g, bls.Fr, bls.R)
    hpk, hvk = groth16.setup(cs, "bls12_381", frng.test_rng(), host=True)
    for q in QUERIES:
        want, got = planes(getattr(pk, q)), planes(getattr(hpk, q))
        assert all(np.array_equal(want[k], got[k]) for k in want), q
    assert ser.vk_to_bytes(hvk) == ser.vk_to_bytes(vk)


def test_saved_keys_load_in_both_packages(keys, tmp_path):
    _, _, pk, vk, _ = keys
    path = str(tmp_path / "toy")
    checkpoint.save_groth16_keys(path, pk)
    jpk = jcheckpoint.load_groth16_keys(path, device=False)
    for q in QUERIES:
        want, got = planes(getattr(pk, q)), planes(getattr(jpk, q))
        assert all(np.array_equal(want[k], got[k]) for k in want), q
    assert jser.vk_to_bytes(jpk.vk) == ser.vk_to_bytes(vk)
    assert point_ints(jpk.beta_g1) == point_ints(pk.beta_g1)
    mine = checkpoint.load_groth16_keys(path, device="cpu")
    for q in QUERIES:
        want, got = planes(getattr(pk, q)), planes(getattr(mine.pk, q))
        assert all(np.array_equal(want[k], got[k]) for k in want), q
    assert mine.pk.l_nonzero == pk.l_nonzero


def test_setup_rng_reproduces_committed_key():
    """The 16-member circuit of bench.py leaves test_rng() in the state the
    committed key's setup found: its beta and delta draws give the json's
    beta_g1 and delta_g1 (the key's planes are checked on the card)."""
    import random

    from zkmember_tpu_torch.app import circuits as app
    from zkmember_tpu_torch.app.member import generate_members

    rng = frng.test_rng()
    cfg = app.get_config("pedersen381")
    leaf_params, node_params = cfg.setup_params(rng)
    digests = [m.hash(leaf_params) for m in generate_members(16)]
    tree = app.new_membership_tree(leaf_params, node_params, digests)
    idx = random.Random(0).randrange(16)
    cs = app.MerkleTreeCircuit(
        config=cfg, leaf_params=leaf_params, node_params=node_params, root=tree.root(),
        leaf_hash=digests[idx], authentication_path=tree.generate_proof(idx),
    ).generate_constraints()
    _alpha, beta, _gamma, delta, _tau = (frng.nonzero_field_element(rng, bls.R) for _ in range(5))
    with open(os.path.join(REPO, "artifacts", "groth16_bls12_381_16.json")) as f:
        meta = json.load(f)
    assert meta["domain_size"] == 1 << (cs.num_constraints + cs.num_instance - 1).bit_length()
    assert ser.sw_point_to_bytes(bls.G1, bls.G1.mul(beta, bls.G1_GEN)).hex() == meta["beta_g1"]
    assert ser.sw_point_to_bytes(bls.G1, bls.G1.mul(delta, bls.G1_GEN)).hex() == meta["delta_g1"]
