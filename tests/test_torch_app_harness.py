"""The port's app harnesses (``app/bench_harness.py``, ``app/scale.py``)
against the JAX package's: the bench rows, the systems `main` dispatches
to (Marlin and its universal mode among them), the universal mode's
padding and Marlin's rows, the checkpoint load (a pedersen761 key too),
the synthetic depth-32 paths and the batched scale circuit."""

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
    (["--systems", "marlin"], [("groth16", None), ("marlin", False)][1:]),
    (["--systems", "groth16,marlin"], [("groth16", None), ("marlin", False)]),
    (["--universal"], [("groth16", None)]),
    (["--stack", "pedersen761", "--systems", "marlin", "--universal"], [("marlin", True)]),
], ids=["marlin", "groth16_marlin", "universal", "pedersen761"])
def test_main_refuses_what_is_not_ported(argv, what, monkeypatch, capsys):
    """Nothing is refused any more: --systems marlin and --universal reach
    bench_marlin (Marlin's universal mode with --universal), on either
    stack, in the order given, with the sizes, reps and device; --universal
    leaves Groth16 as it is (the reference ignores it there)."""
    calls = []
    monkeypatch.setattr(bench_harness, "bench_groth16", lambda stack, sizes, **kw: calls.append(
        ("groth16", None, stack, sizes, kw["reps"], kw["device"])))
    monkeypatch.setattr(bench_harness, "bench_marlin", lambda stack, sizes, **kw: calls.append(
        ("marlin", kw["universal"], stack, sizes, kw["reps"], kw["device"])))
    assert bench_harness.main(argv + ["--sizes", "4,16", "--reps", "1", "--device", "cpu"]) == 0
    stack = "pedersen761" if "pedersen761" in argv else "pedersen381"
    assert calls == [(system, universal, stack, [4, 16], 1, "cpu") for system, universal in what]
    assert "not ported" not in capsys.readouterr().err


def test_registrar_pads_to_the_universal_size(params):
    """pad_to (Marlin's universal mode) pads the registrar with the default
    member's digest, as the reference's _build does; the default member's
    join date is now, so both packages' clocks are pinned."""
    from datetime import datetime, timezone

    from zkmember_tpu.app import member as jmember
    from zkmember_tpu_torch.app import member

    (cfg, lp, np_), (jcfg, jlp, jnp_) = params
    fixed = datetime(2024, 1, 2, 3, 4, 5, tzinfo=timezone.utc)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(member, "_now", lambda: fixed)
        mp.setattr(jmember, "_now", lambda: fixed)
        reg = bench_harness._registrar("pedersen381", 2, pad_to=4, device="cpu")
        pad = jmember.Member.default().hash(jlp)
        want = [m.hash(jlp) for m in jmember.generate_members(2)] + [pad, pad]
        unpadded = bench_harness._registrar("pedersen381", 2, pad_to=2, device="cpu").digests
    assert reg.digests == want and unpadded == want[:2]
    assert reg.tree.root() == japp.new_membership_tree(jlp, jnp_, want).root()


def _two_input_circuit(CS, gadgets, mod):
    """A toy with the membership circuit's public inputs (root, leaf):
    root = w^3 and leaf = w + 1, w = 6."""
    cs = CS(mod.Fr)
    w_val = 6
    root = gadgets.FpVar.new_input(cs, w_val ** 3)
    leaf = gadgets.FpVar.new_input(cs, w_val + 1)
    w = gadgets.FpVar.new_witness(cs, w_val)
    (w * w * w).enforce_equal(root, "root")
    w.add_constant(1).enforce_equal(leaf, "leaf")
    return cs, w_val ** 3, w_val + 1


def test_bench_marlin_rows_match_reference(monkeypatch):
    """bench_marlin on a circuit small enough for the plain kernels (the
    registrar's circuit replaced by a two-input toy): universal mode runs
    setup, index, prove and verify for real; the circuit-specific mode then
    runs on that SRS, index and proof (verify for real).  Every row carries
    the reference's name and fields, verify true."""
    from zkmember_tpu_torch.curves import bls12_381 as bls
    from zkmember_tpu_torch.r1cs import gadgets as g
    from zkmember_tpu_torch.r1cs.cs import ConstraintSystem
    from zkmember_tpu_torch.snark import marlin

    cs, root, leaf = _two_input_circuit(ConstraintSystem, g, bls)
    built = []
    monkeypatch.setattr(bench_harness, "_build",
                        lambda stack, n, pad_to=None, device=None:
                        built.append((n, pad_to, device)) or (cs, root, leaf))
    made = {}

    def keep(name, fn):
        def run(*a, **kw):
            made[name] = fn(*a, **kw)
            return made[name]
        monkeypatch.setattr(marlin, name, run)

    for name in ("universal_setup", "index", "prove"):
        keep(name, getattr(marlin, name))
    rows = []
    bench_harness.bench_marlin("pedersen381", [2], universal=True, reps=1, out=rows.append,
                               device="cpu")
    assert built == [(2, None, "cpu"), (2, 2, "cpu")]
    assert made["universal_setup"].max_degree == marlin.max_degree_bound(
        cs.num_constraints, cs.num_variables, bench_harness._nnz(cs))
    for name in ("universal_setup", "index", "prove"):
        monkeypatch.setattr(marlin, name, lambda *a, _v=made[name], **kw: _v)
    bench_harness.bench_marlin("pedersen381", [2], universal=False, reps=2, out=rows.append,
                               device="cpu")
    parsed = [json.loads(r) for r in rows]
    assert [r["name"] for r in parsed] == [
        "bls12_381_marlin_universal_setup+index_2", "bls12_381_marlin_universal_prove_2",
        "bls12_381_marlin_universal_verify_2", "bls12_381_marlin_setup+index_2",
        "bls12_381_marlin_prove_2", "bls12_381_marlin_prove_2", "bls12_381_marlin_prove_2",
        "bls12_381_marlin_verify_2"]
    for r in parsed:
        system, phase = r["name"][len("bls12_381_"):-len("_2")].rsplit("_", 1)
        stats = {k: r[k] for k in ("min", "median", "reps") if k in r}
        want = jbench._row("bls12_381", system, phase, 2, r["seconds"], cs,
                           ok=r.get("verified"), stats=stats or None)
        assert json.loads(want) == r
    assert [r.get("verified") for r in parsed if r["name"].endswith("verify_2")] == [True, True]
    assert parsed[2]["reps"] == 1 and parsed[-1]["reps"] == parsed[-2]["reps"] == 2


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
