"""bench_cuda.py, the port's counterpart of bench.py, on the CPU.

The bench's inputs (members, tree, member index, circuit) are held against
the JAX package's host steps at 4 and 16 members: equal public inputs and
constraint, variable and boolean counts.  The test rng's state after the
bench's circuit reproduces the host half of the committed 16-member key
(the five toxic-waste draws give its vk, beta, delta and index lists):
bench.py's order of draws made it.  The committed 64-member key came from
the JAX bench harness's sweep, another order; the state that made it is
held the same way (chip_smoke.py's setup and bench phases hold the query
arrays on the card).  The result line has bench.py's keys and baseline table; without a
card main() raises.

With RUN_SLOW=1: main(members=4, device="cpu") end to end (setup on the
plain kernels, the key saved, a second run that loads it and writes
nothing), and that key array for array against the JAX package's
setup(host=True) after the same draws.  On one CPU thread the two runs of
main take over two hours on the plain versions (setup alone about 18
minutes, each proof about 20) and the JAX host setup about 20 minutes, so
those two stay out of Tier-1.
"""

import ast
import json
import os

import numpy as np
import pytest
import torch

from zkmember_tpu.app import circuits as japp
from zkmember_tpu.app.member import Member as JMember
from zkmember_tpu.utils import rng as jrng

import bench_cuda
from zkmember_tpu_torch.app import circuits as app
from zkmember_tpu_torch.app.member import generate_members
from zkmember_tpu_torch.ntt import ntt as nttmod
from zkmember_tpu_torch.snark import groth16
from zkmember_tpu_torch.utils import rng as frng
from zkmember_tpu_torch.utils import serialize as ser

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("metric", "value", "unit", "vs_baseline", "device")
slow = pytest.mark.skipif(not os.environ.get("RUN_SLOW"),
                          reason="setup at 4 members on the plain kernels: run with RUN_SLOW=1")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _bench_inputs(members: int):
    """The bench's members, circuit and public inputs as bench_cuda.main
    builds them, and the rng in the state its setup finds."""
    rng = frng.test_rng()
    cfg = app.get_config("pedersen381")
    leaf_params, node_params = cfg.setup_params(rng)
    people = generate_members(members)
    digests, tree = bench_cuda.membership_tree(leaf_params, node_params, people, "cpu")
    cs, public = bench_cuda.member_circuit(cfg, leaf_params, node_params, digests, tree,
                                           bench_cuda.member_index(members))
    return people, cs, public, rng


@pytest.mark.parametrize("members", [4, 16])
def test_bench_inputs_equal_reference(members):
    """bench.py's steps through the JAX package's host modules, over the same
    members (a digest covers the member's join time), give the bench's
    public inputs and circuit shape."""
    import random

    people, cs, public, _ = _bench_inputs(members)
    jpeople = [JMember.from_json(m.to_json()) for m in people]
    rng = jrng.test_rng()
    cfg = japp.get_config("pedersen381")
    leaf_params, node_params = cfg.setup_params(rng)
    digests = [m.hash(leaf_params) for m in jpeople]
    tree = japp.new_membership_tree(leaf_params, node_params, digests)
    idx = random.Random(0).randrange(members)
    assert bench_cuda.member_index(members) == idx
    jcs = japp.MerkleTreeCircuit(
        config=cfg, leaf_params=leaf_params, node_params=node_params, root=tree.root(),
        leaf_hash=digests[idx], authentication_path=tree.generate_proof(idx),
    ).generate_constraints()
    assert public == [tree.root(), digests[idx]]
    assert (cs.num_constraints, cs.num_variables, len(cs.boolean_vars), cs.num_instance) == (
        jcs.num_constraints, jcs.num_variables, len(jcs.boolean_vars), jcs.num_instance)
    assert cs.is_satisfied()


# the committed keys' draws: the 16-member key's setup found the test rng
# right after bench.py's circuit (setup_params' draws); the other sizes'
# keys came from the JAX bench harness's Groth16 sweep, one fresh test rng
# over the sizes, whose setup at 64 members found it after 29 draws of a
# field element (the sizes before and the proofs between)
KEY_DRAWS = {16: ("bench", 0), 64: ("fresh", 29)}


@pytest.mark.parametrize("members", sorted(KEY_DRAWS))
def test_draws_reproduce_committed_key_host_half(members):
    """From the rng state that made the committed key, the next five draws
    (alpha, beta, gamma, delta, tau, setup's order) give its vk bytes,
    beta_g1, delta_g1, domain and index lists over the bench's circuit.  The
    16-member key is bench.py's order of draws; the 64-member key is not, so
    chip_smoke.py holds the bench's own 64-member key by verification and
    setup from the key's rng state against the committed arrays."""
    start, skip = KEY_DRAWS[members]
    _, cs, _, rng = _bench_inputs(members)
    cfg = groth16.pairing_config("bls12_381")
    r, g1, g2 = cfg.r, cfg.mod.G1, cfg.mod.G2
    G, H = cfg.mod.G1_GEN, cfg.mod.G2_GEN
    if start == "fresh":
        rng = frng.test_rng()
    for _ in range(skip):
        frng.nonzero_field_element(rng, r)
    with open(os.path.join(REPO, "artifacts", f"groth16_bls12_381_{members}.json")) as f:
        meta = json.load(f)
    alpha, beta, gamma, delta, tau = (frng.nonzero_field_element(rng, r) for _ in range(5))
    M = 1 << (cs.num_constraints + cs.num_instance - 1).bit_length()
    assert (meta["domain_size"], meta["num_instance"]) == (M, cs.num_instance)
    u, v, w, _ = groth16.qap_evaluate_at(cs, nttmod.Domain.get(cfg.fr_spec, M), tau)
    ni, nv = cs.num_instance, cs.num_variables
    abc = [(beta * u[i] + alpha * v[i] + w[i]) % r for i in range(nv)]
    gamma_inv, delta_inv = pow(gamma, -1, r), pow(delta, -1, r)
    vk = groth16.VerifyingKey(
        curve="bls12_381", alpha_g1=g1.mul(alpha, G), beta_g2=g2.mul(beta, H),
        gamma_g2=g2.mul(gamma, H), delta_g2=g2.mul(delta, H),
        gamma_abc_g1=[g1.mul(abc[i] * gamma_inv % r, G) for i in range(ni)],
    )
    assert ser.vk_to_bytes(vk).hex() == meta["vk"]
    assert ser.sw_point_to_bytes(g1, g1.mul(beta, G)).hex() == meta["beta_g1"]
    assert ser.sw_point_to_bytes(g1, g1.mul(delta, G)).hex() == meta["delta_g1"]
    assert meta["a_nonzero"] == [i for i in range(nv) if u[i] % r]
    assert meta["b_nonzero"] == [i for i in range(nv) if v[i] % r]
    assert meta["l_nonzero"] == [k for k, i in enumerate(range(ni, nv))
                                 if abc[i] * delta_inv % r]


def _bench_py_baselines() -> dict:
    """The baseline table literal of bench.py's main()."""
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and [getattr(t, "id", None) for t in node.targets] \
                == ["baseline_s"]:
            return ast.literal_eval(node.value.func.value)
    raise AssertionError("bench.py has no baseline_s table")


@pytest.mark.parametrize("members", [4, 16, 1024])
def test_result_line_has_bench_py_keys(members):
    assert bench_cuda.BASELINE_S == _bench_py_baselines()
    line = bench_cuda.result_line(members, 0.123456789, "cpu")
    assert tuple(line) == KEYS
    assert line["metric"] == f"groth16_bls12_381_prove_{members}members"
    assert line["value"] == 0.1235 and line["unit"] == "s" and line["device"] == "cpu"
    assert line["vs_baseline"] == round(bench_cuda.BASELINE_S.get(members, 0.300) / 0.1235, 3)
    assert bench_cuda.device_label(torch.device("cpu")) == "cpu"


def test_main_without_a_card_raises(tmp_path, monkeypatch):
    """No silent CPU path: main() (device=None, the card) raises RuntimeError
    when torch sees no CUDA device, before it builds or writes anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_cuda.main(members=4, checkpoint_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_cuda.main(members=4, device="cuda", checkpoint_dir=str(tmp_path))
    assert not os.listdir(tmp_path)


def _listing(d):
    return sorted((f, os.stat(os.path.join(d, f)).st_mtime_ns) for f in os.listdir(d))


@pytest.fixture(scope="module")
def cpu_run(tmp_path_factory):
    """main(members=4, device="cpu") twice over one key directory: setup and
    save, then load."""
    d = str(tmp_path_factory.mktemp("bench4"))
    first = bench_cuda.main(members=4, device="cpu", checkpoint_dir=d)
    saved = _listing(d)
    second = bench_cuda.main(members=4, device="cpu", checkpoint_dir=d)
    return d, first, saved, second


@slow
def test_main_on_the_cpu_saves_then_loads_the_key(cpu_run):
    d, first, saved, second = cpu_run
    assert [f for f, _ in saved] == ["groth16_bls12_381_4.json", "groth16_bls12_381_4.npz"]
    assert _listing(d) == saved  # the second run loaded the key and wrote nothing
    assert first["setup_s"] > 0 and second["setup_s"] is None
    for line in (first, second):
        assert tuple(line)[:len(KEYS)] == KEYS
        assert line["metric"] == "groth16_bls12_381_prove_4members"
        assert line["value"] > 0 and line["unit"] == "s" and line["device"] == "cpu"
        assert line["vs_baseline"] == round(0.300 / line["value"], 3)  # the table's default
        assert line["M"] == 1 << 13


@slow
def test_bench_setup_key_equals_reference(cpu_run, tmp_path):
    """The key the bench's setup saved at 4 members, array for array and field
    for field, against the JAX package's setup(host=True) after the same
    setup_params draw, saved by the JAX package's checkpoint module."""
    from zkmember_tpu.snark import groth16 as jgroth16
    from zkmember_tpu.utils import checkpoint as jcheckpoint

    d = cpu_run[0]
    rng = jrng.test_rng()
    cfg = japp.get_config("pedersen381")
    leaf_params, node_params = cfg.setup_params(rng)
    digests = [m.hash(leaf_params) for m in
               (JMember.from_json(p.to_json()) for p in generate_members(4))]
    tree = japp.new_membership_tree(leaf_params, node_params, digests)
    idx = bench_cuda.member_index(4)
    jcs = japp.MerkleTreeCircuit(
        config=cfg, leaf_params=leaf_params, node_params=node_params, root=tree.root(),
        leaf_hash=digests[idx], authentication_path=tree.generate_proof(idx),
    ).generate_constraints()
    jpk, _ = jgroth16.setup(jcs, curve="bls12_381", rng=rng, host=True)
    jpath = str(tmp_path / "jax_4")
    jcheckpoint.save_groth16_keys(jpath, jpk)
    keys = []
    for path in (os.path.join(d, "groth16_bls12_381_4"), jpath):
        with np.load(path + ".npz") as data:
            arrays = {k: data[k] for k in data.files}
        with open(path + ".json") as f:
            meta = json.load(f)
        meta.pop("npz_sha256")
        keys.append((arrays, meta))
    (got, got_meta), (want, want_meta) = keys
    assert sorted(got) == sorted(want) and len(want) == 12
    for k in sorted(want):
        assert got[k].shape == want[k].shape and np.array_equal(got[k], want[k]), k
    assert got_meta == want_meta  # vk, beta_g1, delta_g1, domain, index lists
