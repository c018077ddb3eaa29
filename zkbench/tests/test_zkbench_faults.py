"""The check against planted faults and the control, on the CPU: a toy
cell in a temporary copy, the rest of a run as on the card (the look for a
card skipped), the program's entry broken underneath.  Each must come out
``correct: false`` with the proofs counted wrong; the sound run of the same
cell is ``correct: true`` (test_zkbench_spec.py)."""

import json
import os
import subprocess
import sys

import pytest

import toycell
from conftest import ROOT


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return toycell.make_copy(str(tmp_path_factory.mktemp("toycell")))


@pytest.mark.parametrize("fault,cell", [
    ("stale", "toy.single"),
    ("altered", "toy.single"),
    ("half_batch", "toy.batch8"),
])
def test_a_planted_fault_comes_out_not_correct(copy, fault, cell):
    rc, out, err = toycell.run_cpu(copy, ["--workload", cell, "--seed", str(2**32 + 101),
                                          "--seconds", "1", "--trace", "0"],
                                   patch=toycell.FAULTS[fault])
    assert rc == 0, err[-3000:]
    line = toycell.last_json(out)
    assert line["correct"] is False
    checks = line["checks"]
    assert checks["proofs_wrong"]["value"] >= 1 and checks["proofs_wrong"]["limit"] == 0
    assert err.rstrip().splitlines()[-len(checks)].startswith("check proofs_wrong ")


def test_the_control_one_limb_short_comes_out_not_correct(copy):
    code = f"""
import sys, json
sys.path[:0] = [{os.path.join(copy, 'zkbench')!r}, {copy!r}]
sys.path.append({ROOT!r})
import torch
torch.set_num_threads(1)
import control
print(json.dumps(control.run_control("toy.single", {2**31 + 77}, 3, device="cpu", root={copy!r})))
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=copy, capture_output=True, text=True,
                         timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] is False
    assert line["checks"]["proofs_wrong"]["value"] == line["attempted"] == 3
