"""The toy circuit's proof with every MSM sharded (prove_lm.prove(mesh=),
warm_sharded) against the port's single-device proof and the JAX
package's prove_lm.prove.

The circuit is the reference dry run's (out = w^3 plus a boolean select;
entry.toy_circuit), its keys from the host setup with utils.rng.test_rng(),
and every proof draws r and s from that rng after the setup, so A, B and
C must be equal as affine points.  Two gloo worlds run at once
(tests/torch_world.py): 4 ranks on a (1, 4) mesh with the boolean class
merged into the general lanes, 2 ranks on a (1, 2) mesh with it split
out (merge_bool=False: the sharded boolean MSMs); each key is built with
min_lanes = D and warmed by warm_sharded.
"""

import pytest
import torch

from zkmember_tpu.curves import bls12_381 as jbls
from zkmember_tpu.r1cs import gadgets as jg
from zkmember_tpu.r1cs.cs import ConstraintSystem as JCS
from zkmember_tpu.snark import groth16 as jgroth16, prove_lm as jprove_lm
from zkmember_tpu.utils import rng as jrng
from zkmember_tpu_torch import entry
from zkmember_tpu_torch.parallel import dist
from zkmember_tpu_torch.snark import prove_lm
from torch_world import MESH, World

# D (the world's ranks, all on the msm axis) -> merge_bool of its key
WORLDS = {4: True, 2: False}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def worlds():
    return {D: World(D, [(entry.toy_proof, 1, (MESH, merge))])
            for D, merge in WORLDS.items()}


def _ints(pt):
    def c(v):
        return tuple(int(x.v) for x in v.coeffs) if hasattr(v, "coeffs") else int(v.v)

    return (c(pt[0]), c(pt[1]))


@pytest.fixture(scope="module")
def reference(worlds):
    """The JAX package's proof (no mesh) and the port's single-device one,
    made while the worlds run."""
    jcs = JCS(jbls.Fr)
    out_v = jg.FpVar.new_input(jcs, pow(8, 3, jbls.R))
    w = jg.FpVar.new_witness(jcs, 8)
    (w * w * w).enforce_equal(out_v, "cube")
    b1 = jg.Boolean.new_witness(jcs, 1)
    b1.select(out_v, jg.FpVar.constant(jcs, 0)).enforce_equal(out_v, "sel")
    rng = jrng.test_rng()
    pk, _ = jgroth16.setup(jcs, curve="bls12_381", rng=rng, host=True)
    proof = jprove_lm.prove(jprove_lm.Groth16KeysLM(pk, jcs), jcs, rng=rng)
    jax_proof = {k: _ints(getattr(proof, k)) for k in "abc"}
    return jax_proof, entry.toy_proof(None, device="cpu")


def test_single_device_toy_proof_equals_jax(reference):
    jax_proof, single = reference
    assert {k: single[k] for k in "abc"} == jax_proof
    assert single["verifies"] and not single["wrong_input_verifies"]


@pytest.mark.parametrize("D", sorted(WORLDS))
def test_sharded_proof_equals_single_device_and_jax(worlds, reference, D):
    jax_proof, single = reference
    got = worlds[D].result(0)
    assert got == single
    assert {k: got[k] for k in "abc"} == jax_proof
    assert got["verifies"] and not got["wrong_input_verifies"]


def test_prove_refuses_lanes_that_do_not_split():
    cs, _ = entry.toy_circuit()
    from zkmember_tpu_torch.snark import groth16
    from zkmember_tpu_torch.utils import rng as frng

    pk, _ = groth16.setup(cs, curve="bls12_381", rng=frng.test_rng(), host=True)
    keys = prove_lm.Groth16KeysLM(pk, "cpu")  # 64 lanes: not over 128 ranks
    mesh = dist.Mesh(shape={"dp": 1, "msm": 128}, coords={"dp": 0, "msm": 0},
                     device=torch.device("cpu"), groups={})
    with pytest.raises(ValueError, match="min_lanes=128"):
        prove_lm.prove(keys, cs, rng=frng.test_rng(7), mesh=mesh)
    with pytest.raises(ValueError, match="min_lanes=128"):
        prove_lm.warm_sharded(keys, mesh)
