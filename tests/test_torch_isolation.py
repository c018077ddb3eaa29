"""The port stands alone: it imports neither JAX nor the JAX package.

A fresh interpreter imports zkmember_tpu_torch, loads a key from a
checkpoint and proves the toy cube circuit on the CPU with the limb-major
prover, builds a key with the reference's options from it, runs the port's own setup and v1 prover on it, commits to a
polynomial with the port's KZG, loads the CLI, the bench harness and
Marlin, hashes a 4-leaf Merkle tree with the device hash on the CPU (and
loads ``entry``), and then reports what it imported.  Another fresh
interpreter runs a sharded MSM on a 2-rank gloo world (``parallel.dist``),
each rank asserting that it imported nothing of JAX.  An AST scan checks every
module of the package (KZG, Marlin, the transcript, the polynomial
helpers and the ``parallel`` subpackage among them), chip_smoke.py and
bench_cuda.py; a fresh interpreter that imports bench_cuda (the port's
bench.py) has imported nothing of JAX.
"""

import ast
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import json, sys
import torch
torch.set_num_threads(1)
from zkmember_tpu_torch.curves import bls12_381 as bls
from zkmember_tpu_torch.r1cs import gadgets as g
from zkmember_tpu_torch.r1cs.cs import ConstraintSystem
from zkmember_tpu_torch.snark import groth16, prove_lm
from zkmember_tpu_torch.utils import checkpoint, rng as frng

cs = ConstraintSystem(bls.Fr)
out = g.FpVar.new_input(cs, 27)
w = g.FpVar.new_witness(cs, 3)
(w * w * w).enforce_equal(out, "cube")
keys = checkpoint.load_groth16_keys(sys.argv[1], device="cpu")
proof = prove_lm.prove(keys, cs, rng=frng.test_rng(3))
okeys = prove_lm.Groth16KeysLM(keys.pk, "cpu", cs=cs, min_lanes=8, precompute=False,
                               merge_bool=False)
pk, vk = groth16.setup(cs, "bls12_381", frng.test_rng(), device="cpu")
proof_v1 = groth16.prove(pk, cs, rng=frng.test_rng(4), device="cpu")
from zkmember_tpu_torch.app import bench_harness, cli
from zkmember_tpu_torch.snark import kzg, marlin, transcript
from zkmember_tpu_torch.utils import poly
pp = kzg.setup(8, rng=frng.test_rng(), device="cpu")
v, opening = kzg.open_at(pp, [1, 2, 3], 5)
from zkmember_tpu_torch import entry
from zkmember_tpu_torch.app import circuits as app
from zkmember_tpu_torch.hash import pedersen
from zkmember_tpu_torch.merkle import tree
leaf_params, node_params = app.get_config("pedersen381").setup_params(frng.test_rng())
leaves = [bytes([i]) * 32 for i in range(4)]
dev_tree = tree.MerkleTree(leaf_params, node_params, leaves, backend="device", device="cpu")
host_tree = tree.MerkleTree(leaf_params, node_params, leaves, backend="host")
print(json.dumps({
    "tree": dev_tree.root() == host_tree.root() and callable(entry.entry)
            and callable(pedersen.hash_bits_device),
    "kzg": kzg.check(pp, kzg.commit(pp, [1, 2, 3]), 5, v, opening),
    "options": okeys.g1_tab is None and okeys.g2_tab is None and okeys.Bb == 8,
    "ok": groth16.verify(keys.pk.vk, [27], proof),
    "bad": groth16.verify(keys.pk.vk, [28], proof),
    "ok_v1": groth16.verify(vk, [27], proof_v1),
    "bad_v1": groth16.verify(vk, [28], proof_v1),
    "modules": sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib", "zkmember_tpu."))),
}))
"""


RANKS_SCRIPT = r"""
import json, random, sys
import numpy as np
import torch
from zkmember_tpu_torch.curves import bls12_381 as bls
from zkmember_tpu_torch.fields import spec as fs
from zkmember_tpu_torch.msm import straus
from zkmember_tpu_torch.parallel import dist
from zkmember_tpu_torch.snark import groth16, prove_lm


def forbidden():
    return sorted(m for m in sys.modules
                  if m == "jax" or m.startswith(("jax.", "jaxlib", "zkmember_tpu.")))


def rank(mesh):
    assert not forbidden(), forbidden()
    rng = random.Random(3)
    pts = [bls.G1.mul(rng.randrange(1, bls.R), bls.G1_GEN) for _ in range(4)] * 16
    scalars = [rng.randrange(256) for _ in pts]

    def plane(vals):
        return torch.as_tensor(fs.to_lm(vals).astype(np.int64), dtype=torch.int32)

    X = plane(fs.BLS_FQ.to_mont_host([p[0].v for p in pts]))
    Y = plane(fs.BLS_FQ.to_mont_host([p[1].v for p in pts]))
    z = plane(fs.ints_to_limbs(scalars, 16))
    ops = prove_lm.sw_ops(groth16.pairing_config("bls12_381"), False, "cpu")
    got = straus.projective_to_host(bls.G1, straus.sharded_msm_program(ops, mesh, X, Y, z, 2))
    want = None
    for s, p in zip(scalars, pts):
        want = bls.G1.add(want, bls.G1.mul(s, p))
    assert not forbidden(), forbidden()
    return {"rank": mesh.rank, "equal": got == want, "modules": forbidden()}


if __name__ == "__main__":
    torch.set_num_threads(1)
    print(json.dumps(dist.run_ranks(rank, 2, device="cpu")))
"""


def test_sharded_msm_ranks_import_no_jax(tmp_path):
    script = tmp_path / "ranks.py"
    script.write_text(RANKS_SCRIPT)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, str(script)], cwd=str(tmp_path), env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got == {"rank": 0, "equal": True, "modules": []}


def test_bench_cuda_imports_no_jax(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    code = ("import json, sys, bench_cuda; print(json.dumps(sorted(m for m in sys.modules "
            "if m == 'jax' or m.startswith(('jax.', 'jaxlib', 'zkmember_tpu.')) "
            "or m == 'zkmember_tpu')))")
    res = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


def _is_forbidden(name: str) -> bool:
    return name == "jax" or name.startswith(("jax.", "jaxlib")) or name == "zkmember_tpu" \
        or name.startswith("zkmember_tpu.")


def test_port_proves_without_jax(tmp_path):
    from zkmember_tpu.curves import bls12_381 as jbls
    from zkmember_tpu.r1cs import gadgets as jg
    from zkmember_tpu.r1cs.cs import ConstraintSystem
    from zkmember_tpu.snark import groth16 as jgroth16
    from zkmember_tpu.utils import checkpoint as jcheckpoint
    from zkmember_tpu.utils import rng as jrng

    cs = ConstraintSystem(jbls.Fr)
    out = jg.FpVar.new_input(cs, 27)
    w = jg.FpVar.new_witness(cs, 3)
    (w * w * w).enforce_equal(out, "cube")
    pk, _ = jgroth16.setup(cs, curve="bls12_381", rng=jrng.test_rng(), host=True)
    path = str(tmp_path / "toy")
    jcheckpoint.save_groth16_keys(path, pk)

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run(
        [sys.executable, "-c", CHILD, path], cwd=str(tmp_path), env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr[-4000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got == {"tree": True, "kzg": True, "options": True, "ok": True, "bad": False, "ok_v1": True, "bad_v1": False,
                   "modules": []}


def _sources():
    pkg = os.path.join(REPO, "zkmember_tpu_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")
    yield os.path.join(REPO, "bench_cuda.py")


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _is_forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _is_forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"
