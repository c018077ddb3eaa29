"""The run's refusals: no card, JAX loaded, no program; and what the
harness and the reference import."""

import ast
import json
import os
import subprocess
import sys

import pytest

import toycell
from conftest import ROOT, ZKBENCH


def load_run():
    import importlib.util

    spec = importlib.util.spec_from_file_location("zkbench_run", os.path.join(ZKBENCH, "run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_a_run_without_a_card_fails_and_prints_no_result(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(os, "environ", dict(os.environ))  # host.json's settings stay here
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    rc = load_run().main(["--workload", "groth16-bls12_381-depth32.single", "--seed", "1",
                          "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc == 3 and out.out == "" and "needs 1 CUDA device" in out.err


def test_the_jax_check_compares_whole_top_level_names():
    run = load_run()
    assert run.forbidden_modules({"jax.numpy", "zkmember_tpu.fields.lm", "numpy"}) == ["jax", "zkmember_tpu"]
    assert run.forbidden_modules({"zkmember_tpu_torch", "zkmember_tpu_torch.snark", "jaxtyping",
                                  "flaxen", "zkb.loop"}) == []
    assert run.forbidden_modules({"flax.linen", "jaxlib"}) == ["flax", "jaxlib"]


def test_what_a_run_imports_holds_no_jax():
    """Every module a run loads (the harness, every cell's circuit and
    readers, the reference, the program's prover) in a fresh process."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cells = [w["name"] for w in json.load(f)["workloads"]]
    code = f"""
import sys
sys.path[:0] = [{ZKBENCH!r}, {ROOT!r}]
from zkb import loop, spec, check, trace, peaks, traffic
from reference import groth16_ref, pedersen_ref
import control
for c in {cells!r}:
    cell = spec.load_cell(c)
    for m in cell.end_to_end + cell.per_layer:
        assert callable(m.reader.read)
from zkmember_tpu_torch.snark import groth16, prove_lm
from zkmember_tpu_torch.app import circuits, member
from zkmember_tpu_torch.hash import pedersen
from zkmember_tpu_torch.merkle import tree
from zkmember_tpu_torch import kernels, native
import importlib.util
s = importlib.util.spec_from_file_location("r", {os.path.join(ZKBENCH, 'run.py')!r})
m = importlib.util.module_from_spec(s); s.loader.exec_module(m)
print(m.forbidden_modules(sys.modules))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().splitlines()[-1] == "[]"


def imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_file_of_the_benchmark_imports_jax_and_the_reference_imports_nothing_of_the_program():
    for d, _, files in os.walk(ZKBENCH):
        for f in files:
            if f.endswith(".py"):
                tops = {m.split(".")[0] for m in imports(os.path.join(d, f))}
                assert not tops & {"jax", "jaxlib", "flax", "zkmember_tpu"}, (f, tops)
    plain = {"__future__", "dataclasses", "functools", "json", "os", "reference", "zkb"}
    for d, _, files in os.walk(os.path.join(ZKBENCH, "reference")):
        for f in files:
            if f.endswith(".py"):
                tops = {m.split(".")[0] for m in imports(os.path.join(d, f))}
                assert tops <= plain, (f, tops - plain)
    assert {m.split(".")[0] for m in imports(os.path.join(ZKBENCH, "zkb", "traffic.py"))} <= \
        {"__future__", "random"}


def test_a_checkout_of_the_benchmark_alone_fails_and_prints_no_result(tmp_path):
    """Only BENCHMARK.json and zkbench/: the program is missing."""
    root = toycell.make_copy(str(tmp_path))
    code = f"""
import sys
sys.path[:0] = [{os.path.join(root, 'zkbench')!r}, {root!r}]
import run
sys.exit(run.main(["--workload", "toy.single", "--seed", "1", "--seconds", "1", "--trace", "0"], device="cpu"))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         timeout=300, env=env)
    assert res.returncode != 0 and res.stdout.strip() == ""
    assert "zkmember_tpu_torch" in res.stderr
