"""End to end on the toy cube circuit: the port's Groth16 proof equals the
JAX package's under the same seed.

The JAX package builds the key (groth16.setup, host=True); the test hands
it to the port as plain numpy arrays and ints (prove_lm.keys_from_numpy),
so the port never sees a JAX object.  Both provers draw r and s from
utils.rng.test_rng(7), so A, B and C must be equal as affine points.
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
from zkmember_tpu_torch.r1cs import gadgets as g
from zkmember_tpu_torch.r1cs.cs import ConstraintSystem
from zkmember_tpu_torch.snark import groth16, prove_lm
from zkmember_tpu_torch.utils import rng as frng


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def cube_circuit(CS, gadgets, Fr, R, wv=8):
    """The toy circuit of __graft_entry__: out = w^3, plus a boolean select;
    the witness w = wv."""
    cs = CS(Fr)
    out_val = pow(wv, 3, R)
    out_v = gadgets.FpVar.new_input(cs, out_val)
    w = gadgets.FpVar.new_witness(cs, wv)
    t = w * w
    (t * w).enforce_equal(out_v, "cube")
    b1 = gadgets.Boolean.new_witness(cs, 1)
    b1.select(out_v, gadgets.FpVar.constant(cs, 0)).enforce_equal(out_v, "sel")
    return cs, out_val


def point_ints(pt):
    def c(v):
        return tuple(int(x.v) for x in v.coeffs) if hasattr(v, "coeffs") else int(v.v)

    return (c(pt[0]), c(pt[1]))


def key_as_numpy(pk, vk):
    """A JAX ProvingKey as the plain arrays and ints keys_from_numpy takes."""
    planes = {}
    for name in ("a_query", "b_g1_query", "b_g2_query", "h_query", "l_query"):
        pa = getattr(pk, name)
        for cn, c in (("x", pa.x), ("y", pa.y)):
            if isinstance(c, tuple):
                for i, ci in enumerate(c):
                    planes[f"{name}_{cn}_c{i}"] = np.asarray(ci)
            else:
                planes[f"{name}_{cn}"] = np.asarray(c)
    return planes, dict(
        curve=pk.curve, a_nonzero=list(pk.a_nonzero), b_nonzero=list(pk.b_nonzero),
        l_nonzero=list(pk.l_nonzero), domain_size=pk.domain_size,
        num_instance=pk.num_instance,
        vk={"alpha_g1": point_ints(vk.alpha_g1), "beta_g2": point_ints(vk.beta_g2),
            "gamma_g2": point_ints(vk.gamma_g2), "delta_g2": point_ints(vk.delta_g2),
            "gamma_abc_g1": [point_ints(p) for p in vk.gamma_abc_g1]},
        beta_g1=point_ints(pk.beta_g1), delta_g1=point_ints(pk.delta_g1),
    )


def test_toy_proof_equals_reference_and_verifies():
    jcs, out_val = cube_circuit(JCS, jg, jbls.Fr, jbls.R)
    cs, _ = cube_circuit(ConstraintSystem, g, bls.Fr, bls.R)
    assert cs.is_satisfied() and cs.num_variables == jcs.num_variables
    pk, vk = jgroth16.setup(jcs, curve="bls12_381", rng=jrng.test_rng(), host=True)
    planes, meta = key_as_numpy(pk, vk)

    keys = prove_lm.keys_from_numpy(planes, device="cpu", **meta)
    phases = {}
    proof = prove_lm.prove(keys, cs, rng=frng.test_rng(7), phase_times=phases)
    assert set(phases) == {
        "matrix_evals", "h_pipeline", "witness_planes", "g1_select_reduce", "g1_finish",
        "g2_select_reduce", "g2_finish", "fetch", "assemble",
    }
    ref = jprove_lm.prove(jprove_lm.Groth16KeysLM(pk, jcs), jcs, rng=jrng.test_rng(7))
    for got, want in ((proof.a, ref.a), (proof.b, ref.b), (proof.c, ref.c)):
        assert point_ints(got) == point_ints(want)

    # the port's proof verifies under both verifiers; tampered ones do not
    pvk = keys.pk.vk
    assert groth16.verify(pvk, [out_val], proof)
    assert not groth16.verify(pvk, [(out_val + 1) % bls.R], proof)
    neg_c = groth16.Proof(curve=proof.curve, a=proof.a, b=proof.b, c=bls.G1.neg(proof.c))
    assert not groth16.verify(pvk, [out_val], neg_c)
    as_ref = jgroth16.Proof(
        curve="bls12_381",
        a=tuple(jbls.Fq(v) for v in point_ints(proof.a)),
        b=tuple(jbls.fq2(*v) for v in point_ints(proof.b)),
        c=tuple(jbls.Fq(v) for v in point_ints(proof.c)),
    )
    assert jgroth16.verify(vk, [out_val], as_ref)
    assert not jgroth16.verify(vk, [(out_val + 1) % jbls.R], as_ref)


def _toy_keys(**opts):
    cs, _ = cube_circuit(ConstraintSystem, g, bls.Fr, bls.R)
    pk, _ = groth16.setup(cs, "bls12_381", frng.test_rng(), host=True)
    return prove_lm.Groth16KeysLM(pk, "cpu", cs=cs, **opts)


def _warm_lines(err: str, tag: str) -> list:
    """The names of the `# [<tag>] <name> ready in <s>s` lines of stderr."""
    import re

    lines = err.splitlines()
    names = [m.group(1) for m in (re.fullmatch(rf"# \[{tag}\] (\w+) ready in \d+\.\ds", ln)
                                  for ln in lines) if m]
    assert len(names) == len(lines), lines
    return names


@pytest.mark.parametrize("verbose", [True, False])
def test_warm_logs_each_step_when_verbose(capsys, verbose):
    """warm(keys, verbose=True) logs the kernel step and the table build in the
    reference's format (zkmember_tpu/snark/prove_lm.py:298-300); verbose=False
    prints nothing; the tables are resident either way."""
    keys = _toy_keys()
    capsys.readouterr()
    prove_lm.warm(keys, verbose=verbose)
    out, err = capsys.readouterr()
    assert out == ""
    assert _warm_lines(err, "warm") == (["kernels", "tables"] if verbose else [])
    assert keys._g1_tab is not None and keys._g2_tab is not None


def _warm_sharded_rank(mesh, keys, verbose):
    prove_lm.warm_sharded(keys, mesh, verbose=verbose)
    return mesh.shape["msm"]


@pytest.mark.parametrize("verbose", [True, False])
def test_warm_sharded_logs_each_msm_class_when_verbose(capsys, verbose):
    """warm_sharded over a one-rank gloo mesh logs one `# [warm-sh]` line an MSM
    class it runs, the reference's names (G1's stacked rows, G2's and, for a
    merge_bool=False key, both boolean classes); verbose=False prints nothing."""
    from zkmember_tpu_torch.parallel import dist

    keys = _toy_keys(merge_bool=False)
    assert keys.has_bool
    capsys.readouterr()
    assert dist.run_ranks(_warm_sharded_rank, 1, device="cpu", args=(keys, verbose)) == 1
    out, err = capsys.readouterr()
    assert out == ""
    assert _warm_lines(err, "warm-sh") == (["g1x4", "g2", "g1bool", "g2bool"] if verbose else [])
