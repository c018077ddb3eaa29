"""The port's app harnesses (``app/bench_harness.py``, ``app/scale.py``)
against the JAX package's: the bench rows, the refusals of what the port
does not have, the checkpoint load (a pedersen761 key too), the synthetic depth-32 paths and the
batched scale circuit."""

import json
import types

import pytest
import torch

from zkmember_tpu.app import bench_harness as jbench, circuits as japp, scale as jscale
from zkmember_tpu.r1cs import gadgets as jg
from zkmember_tpu.r1cs.cs import ConstraintSystem as JCS
from zkmember_tpu.utils import rng as jrng
from zkmember_tpu_torch.app import bench_harness, circuits as app, scale
from zkmember_tpu_torch.utils import rng as frng


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def params():
    """Both packages' pedersen381 CRH parameters from the test rng."""
    cfg = app.get_config("pedersen381")
    jcfg = japp.get_config("pedersen381")
    return (cfg, *cfg.setup_params(frng.test_rng())), (jcfg, *jcfg.setup_params(jrng.test_rng()))


@pytest.mark.parametrize("kw", [
    dict(),
    dict(ok=True, stats={"min": 0.1235, "median": 0.2, "reps": 3}),
    dict(note="checkpoint"),
    dict(ok=False, note="cold", stats={"batch": 4, "proofs_per_sec": 7.5}),
], ids=["plain", "stats", "note", "all"])
def test_row_matches_reference(kw):
    cs = types.SimpleNamespace(num_constraints=13849, num_variables=13845)
    args = ("bls12_381", "groth16", "prove", 16, 0.123456789, cs)
    assert bench_harness._row(*args, **kw) == jbench._row(*args, **kw)
    row = json.loads(bench_harness._row(*args, **kw))
    assert row["name"] == "bls12_381_groth16_prove_16" and row["seconds"] == 0.1235


@pytest.mark.parametrize("argv,what", [
    (["--systems", "marlin"], "marlin"),
    (["--systems", "groth16,marlin"], "marlin"),
    (["--universal"], "--universal"),
    (["--stack", "pedersen761", "--systems", "marlin"], "marlin"),
], ids=["marlin", "groth16_marlin", "universal", "pedersen761"])
def test_main_refuses_what_is_not_ported(argv, what, capsys):
    """Marlin is refused on either stack; pedersen761 itself is ported
    (its rows: test_pedersen761_rows_on_toy_keys)."""
    assert bench_harness.main(argv + ["--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert what in err and "not ported" in err and "pedersen761" not in err


def test_pedersen761_rows_on_toy_keys(tmp_path):
    """--stack pedersen761 reaches the BW6-761 key: a toy key saved as
    <dir>/groth16_bw6_761_16 loads through `_keys` (row
    bw6_761_groth16_setup_load_16) as a BW6-761 Groth16KeysLM, and the
    grid's rows carry the reference's names."""
    from zkmember_tpu_torch.curves import bw6_761 as bw6
    from zkmember_tpu_torch.r1cs import gadgets as g
    from zkmember_tpu_torch.r1cs.cs import ConstraintSystem
    from zkmember_tpu_torch.snark import groth16
    from zkmember_tpu_torch.utils import checkpoint

    assert bench_harness.CURVES["pedersen761"] == "bw6_761"
    cs = ConstraintSystem(bw6.Fr)
    out = g.FpVar.new_input(cs, 125)
    w = g.FpVar.new_witness(cs, 5)
    (w * w * w).enforce_equal(out, "cube")
    pk, _ = groth16.setup(cs, "bw6_761", frng.test_rng(), host=True)
    checkpoint.save_groth16_keys(str(tmp_path / "groth16_bw6_761_16"), pk)
    rows = []
    keys = bench_harness._keys(cs, "bw6_761", 16, frng.test_rng(), "cpu", str(tmp_path),
                               rows.append)
    assert keys.cfg.name == "bw6_761" and keys.ops2.F.spec.n == 48 and keys.nwin == 95
    assert [json.loads(r)["name"] for r in rows] == ["bw6_761_groth16_setup_load_16"]
    row = bench_harness._row("bw6_761", "groth16", "prove", 16, 1.5, cs, ok=True)
    assert row == jbench._row("bw6_761", "groth16", "prove", 16, 1.5, cs, ok=True)
    assert json.loads(row)["name"] == "bw6_761_groth16_prove_16"


def test_main_rejects_an_unknown_system(capsys):
    assert bench_harness.main(["--systems", "plonk", "--device", "cpu"]) == 1
    assert "unknown system plonk" in capsys.readouterr().err


def test_committed_key_loads_from_the_checkpoint_dir(tmp_path):
    """With the key present, `_keys` loads it (row setup_load) and writes
    nothing."""
    import os
    import shutil

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for ext in (".json", ".npz"):
        shutil.copy(os.path.join(repo, "artifacts", "groth16_bls12_381_16" + ext), tmp_path)
    before = sorted(os.listdir(tmp_path))
    rows = []
    cs = types.SimpleNamespace(num_constraints=13849, num_variables=13845)
    keys = bench_harness._keys(cs, "bls12_381", 16, frng.test_rng(), "cpu", str(tmp_path),
                               rows.append)
    assert keys.M == 1 << 14 and keys.device.type == "cpu"
    assert [json.loads(r)["name"] for r in rows] == ["bls12_381_groth16_setup_load_16"]
    assert json.loads(rows[0])["note"] == "checkpoint"
    assert sorted(os.listdir(tmp_path)) == before


@pytest.mark.parametrize("seed", [0, 5])
def test_synthetic_path_matches_reference(params, seed):
    (cfg, lp, np_), (jcfg, jlp, jnp_) = params
    root, leaf, path = scale.synthetic_path(cfg, lp, np_, 32, seed=seed)
    jroot, jleaf, jpath = jscale.synthetic_path(jcfg, jlp, jnp_, 32, seed=seed)
    assert (root, leaf, path.siblings, path.leaf_index, path.leaf_digest) == (
        jroot, jleaf, jpath.siblings, jpath.leaf_index, jpath.leaf_digest)
    assert len(path.siblings) == 32


def _reference_batch_circuit(jcfg, jlp, jnp_, cases):
    """The reference's batch > 1 circuit of zkmember_tpu.app.scale.run_depth."""
    cs = JCS(jcfg.scalar_field)
    io = []
    for root, leaf_digest, _ in cases:
        io.append(jg.FpVar.new_input(cs, root))
        io.append(jg.FpVar.new_input(cs, leaf_digest))
    for k, (_, _, path) in enumerate(cases):
        d = len(path.siblings)
        bits = [jg.Boolean.new_witness(cs, (path.leaf_index >> i) & 1) for i in range(d)]
        sibs = [jg.FpVar.new_witness(cs, s) for s in path.siblings]
        jg.merkle_path_gadget(cs, jlp, jnp_, io[2 * k], io[2 * k + 1], bits, sibs).enforce_true()
    return cs


@pytest.mark.parametrize("batch", [1, 2])
def test_scale_circuit_matches_reference(params, batch):
    """The depth-2 scale circuit, one membership or a batch of two in one
    R1CS: the reference's constraint, variable and boolean counts, the same
    public inputs, satisfied; a wrong root is not."""
    (cfg, lp, np_), (jcfg, jlp, jnp_) = params
    cases = [scale.synthetic_path(cfg, lp, np_, 2, seed=i) for i in range(batch)]
    jcases = [jscale.synthetic_path(jcfg, jlp, jnp_, 2, seed=i) for i in range(batch)]
    cs, public = scale.scale_circuit(cfg, lp, np_, cases)
    if batch == 1:
        root, leaf, path = jcases[0]
        jcs = japp.MerkleTreeCircuit(config=jcfg, leaf_params=jlp, node_params=jnp_, root=root,
                                     leaf_hash=leaf, authentication_path=path).generate_constraints()
    else:
        jcs = _reference_batch_circuit(jcfg, jlp, jnp_, jcases)
    assert cs.is_satisfied() and jcs.is_satisfied()
    assert (cs.num_constraints, cs.num_variables, cs.num_instance, len(cs.boolean_vars)) == (
        jcs.num_constraints, jcs.num_variables, jcs.num_instance, len(jcs.boolean_vars))
    assert public == [v for c in jcases for v in (c[0], c[1])]
    bad = [((cases[0][0] + 1) % cfg.scalar_field.p,) + cases[0][1:]] + cases[1:]
    assert not scale.scale_circuit(cfg, lp, np_, bad)[0].is_satisfied()
