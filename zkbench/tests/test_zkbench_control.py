"""The control on the card, at each cell's own size: the reference in the
program's place one 16-bit limb short of the configuration's scalar field
(``zkbench/control.py``), on three seeds, about as many proofs as a run of
the cell checks.  Every proof must be counted wrong and the run not
correct.

  python3 -m pytest -p no:cacheprovider -q -s zkbench/tests/test_zkbench_control.py -m cuda
"""

import json
import os

import pytest

from conftest import ROOT

PROOFS = 80  # about the proofs a run of a cell checks (depth32: 73-89 in 51 s)
SEEDS = (2**31 + 1001, 2**31 + 1002, 2**31 + 1003)
with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    CELLS = [w["name"] for w in json.load(_f)["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_at_the_cells_size_comes_out_not_correct(card, cell):
    import control
    from zkb import spec

    mix = spec.load_cell(cell).traffic
    requests = max(1, PROOFS // mix["proofs_per_request"])
    for seed in SEEDS:
        line = control.run_control(cell, seed, requests)
        print(json.dumps(line))
        assert line["correct"] is False
        assert line["checks"]["proofs_wrong"]["value"] == line["attempted"] > 0
