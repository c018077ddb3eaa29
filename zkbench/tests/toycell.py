"""A toy cell added to a temporary copy of the benchmark as new files and
entries only: a cube circuit (out = w^3, out public) over BLS12-381, its
reference's public inputs, its configuration, and two cells over the
existing mixes."""

from __future__ import annotations

import hashlib
import json
import os
import shutil

from conftest import ROOT

CIRCUIT = '''"""A toy circuit: out = w^3 for a member's w drawn from the seed, out public."""

from zkb.spec import Registrar
from zkb.traffic import stream


def build(config, seed, device):
    from zkmember_tpu_torch.curves import bls12_381 as bls
    from zkmember_tpu_torch.r1cs import gadgets as g
    from zkmember_tpu_torch.r1cs.cs import ConstraintSystem

    rng = stream(seed, "toy")
    ws = [rng.randrange(2, 1 << 20) for _ in range(config["members"])]

    def synthesize(i):
        cs = ConstraintSystem(bls.Fr)
        out = g.FpVar.new_input(cs, pow(ws[i], 3, bls.R))
        x = g.FpVar.new_witness(cs, ws[i])
        (x * x * x).enforce_equal(out, "cube")
        return cs

    return Registrar("bls12_381", len(ws), synthesize)
'''

PUBLICS = '''"""The toy circuit's public input, out = w^3, from the seed alone."""

from reference.groth16_ref import curve_constants
from zkb.traffic import stream


def publics(config, seed, members):
    r = curve_constants(config["curve"])["r"]
    rng = stream(seed, "toy")
    ws = [rng.randrange(2, 1 << 20) for _ in range(config["members"])]
    return {i: [pow(ws[i], 3, r)] for i in members}
'''

CONFIG = {"name": "toy", "circuit": "toy_cube", "system": "groth16", "curve": "bls12_381",
          "members": 10, "constraints": 3, "instance": 2, "variables": 5, "domain_size": 8,
          "fq_limbs": 24, "fr_limbs": 16, "reduced": []}
CELLS = ("toy.single", "toy.batch8")


def digests(root: str) -> dict:
    """SHA-256 of BENCHMARK.json and every file under zkbench/."""
    out = {}
    paths = [os.path.join(root, "BENCHMARK.json")]
    for d, _, files in os.walk(os.path.join(root, "zkbench")):
        paths += [os.path.join(d, f) for f in files if not f.endswith(".pyc")]
    for p in paths:
        with open(p, "rb") as f:
            out[os.path.relpath(p, root)] = hashlib.sha256(f.read()).hexdigest()
    return out


def make_copy(dst: str) -> str:
    """BENCHMARK.json and zkbench/ copied to dst, then the toy cell added:
    new files, and new entries appended to BENCHMARK.json's lists."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    shutil.copytree(os.path.join(ROOT, "zkbench"), os.path.join(dst, "zkbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(dst, "zkbench", "circuits", "toy_cube.py"), "x") as f:
        f.write(CIRCUIT)
    with open(os.path.join(dst, "zkbench", "reference", "circuits", "toy_cube.py"), "x") as f:
        f.write(PUBLICS)
    with open(os.path.join(dst, "zkbench", "configs", "toy.json"), "x") as f:
        json.dump(CONFIG, f)
    path = os.path.join(dst, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "toy", "source": "a cube circuit for the tests",
                             "file": "zkbench/configs/toy.json", "reduced": [], "why": "tests"})
    bench["workloads"] += [{"name": c, "config": "toy", "traffic": c.split(".")[1], "chips": 1,
                            "why": "tests"} for c in CELLS]
    if "proofs_per_s" not in {m["name"] for m in bench["end_to_end"]}:
        bench["end_to_end"].append({"name": "proofs_per_s", "unit": "proofs/s", "better": "higher",
                                    "bound": 0.25, "source": "host_clock", "workloads": []})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            single = m["name"] == "prove_s" or m["name"].endswith(".single")
            m["workloads"].append("toy.single" if single else "toy.batch8")
    with open(path, "w") as f:
        json.dump(bench, f)
    return dst


LAUNCHER = '''
import sys
sys.path[:0] = [{zkbench!r}, {root!r}]
sys.path.append({repo!r})
import torch
torch.set_num_threads(1)
{patch}
import run
sys.exit(run.main({argv!r}, device="cpu"))
'''

# faults planted in the program's entries, under the harness
FAULTS = {
    # a step that returns its state unchanged: every call after the first
    # returns the first call's proof
    "stale": '''
from zkmember_tpu_torch.snark import prove_lm
_real, _first = prove_lm.prove, []
def prove(keys, cs, rng=None, phase_times=None, mesh=None):
    p = _real(keys, cs, rng=rng, phase_times=phase_times)
    _first.append(p)
    return _first[0]
prove_lm.prove = prove
''',
    # half of the batch left out: the first half proved, its proofs repeated
    "half_batch": '''
from zkmember_tpu_torch.snark import prove_lm
_real = prove_lm.prove_batch
def prove_batch(keys, cs_list, rng=None, phase_times=None):
    half = _real(keys, cs_list[: len(cs_list) // 2], rng=rng, phase_times=phase_times)
    return (half * 2)[: len(cs_list)]
prove_lm.prove_batch = prove_batch
''',
    # an answer altered where it is produced: C's x coordinate plus one
    "altered": '''
from zkmember_tpu_torch.snark import groth16, prove_lm
_real = prove_lm.prove
def prove(keys, cs, rng=None, phase_times=None, mesh=None):
    p = _real(keys, cs, rng=rng, phase_times=phase_times)
    x, y = p.c
    return groth16.Proof(curve=p.curve, a=p.a, b=p.b, c=(x + type(x)(1), y))
prove_lm.prove = prove
''',
}


def run_cpu(root: str, argv: list, patch: str = "", timeout: float = 900):
    """zkbench/run.py's main in a fresh process on the CPU (the look for a
    card skipped), from the copy at root, the program from this checkout,
    with `patch` run first.  Returns (rc, stdout, stderr)."""
    import subprocess
    import sys

    code = LAUNCHER.format(zkbench=os.path.join(root, "zkbench"), root=root, repo=ROOT,
                         patch=patch, argv=argv)
    res = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         timeout=timeout)
    return res.returncode, res.stdout, res.stderr


def last_json(stdout: str) -> dict:
    return json.loads(stdout.strip().splitlines()[-1])
