"""BENCHMARK.json against the benchmark's contract, every cell resolved to
its files by name, and a toy cell added as new files only."""

import json
import os
import re

import pytest

import toycell
from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def line_ok(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_benchmark_json_keeps_to_the_contract(bench):
    assert set(bench) == KEYS["top"]
    assert bench["command"] == ["python3", "zkbench/run.py"] and bench["paths"] == ["zkbench"]
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    cells = {w["name"] for w in bench["workloads"]}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in bench[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in bench["configs"]:
        assert set(c) == KEYS["config"] and line_ok(c["source"]) and line_ok(c["why"])
        assert c["file"].startswith("zkbench/") and os.path.isfile(os.path.join(ROOT, c["file"]))
        with open(os.path.join(ROOT, c["file"])) as f:
            data = json.load(f)
        assert data["reduced"] == c["reduced"] and set(c["reduced"]) <= set(data)
        assert any(w["config"] == c["name"] for w in bench["workloads"])
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == KEYS["workload"] and line_ok(w["why"]) and w["chips"] == 1
        assert w["name"] == f"{w['config']}.{w['traffic']}" and NAME.match(w["traffic"])
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(bench["workloads"])
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert {"prove_s", "setup_s"} <= set(e2e) <= {"proofs_per_s", "prove_s", "setup_s"}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == KEYS["end_to_end"] and m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == KEYS["per_layer"] and line_ok(m["layer"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] == {"batch": "proofs_per_s", "single": "prove_s"}[m["name"].split(".")[1]]
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    for w in cells:  # each cell: setup_s, another end-to-end metric, a per-layer one
        mine = [m for m in bench["end_to_end"] if w in m.get("workloads", cells)]
        assert len(mine) >= 2 and any(m["name"] == "setup_s" for m in mine)
        assert any(w in m["workloads"] for m in bench["per_layer"])
    assert len(json.dumps(bench)) < 64 * 1024


with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    CELLS = [w["name"] for w in json.load(_f)["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves_to_its_files_by_name(cell):
    from zkb import spec

    c = spec.load_cell(cell)
    assert c.config["name"] == c.config_name
    assert c.traffic["entry"] == ("prove_batch" if cell.endswith(".batch8") else "prove")
    assert hasattr(c.circuit, "build") and callable(c.publics.publics)
    assert all(callable(getattr(c.system, f)) for f in
               ("setup", "program_prover", "reference", "read_back", "msm_rows", "numbers"))
    assert {"constraints", "instance", "variables", "domain_size"} <= set(c.config)  # check.SHAPE
    ends = {m.name for m in c.end_to_end}
    assert ends == {"setup_s", "proofs_per_s" if cell.endswith(".batch8") else "prove_s"}
    for m in c.end_to_end + c.per_layer:
        assert callable(m.reader.read)
    variant = ".single" if cell.endswith(".single") else ".batch"
    assert {m.name for m in c.per_layer} >= {f"msm_roofline{variant}", f"device_idle{variant}"}


def test_a_toy_cell_added_as_new_files_runs_with_no_file_edited(tmp_path):
    before = toycell.digests(ROOT)
    root = toycell.make_copy(str(tmp_path))
    after = toycell.digests(root)
    assert {k: v for k, v in after.items() if k in before and k != "BENCHMARK.json"} == \
        {k: v for k, v in before.items() if k != "BENCHMARK.json"}
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        old = json.load(f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        new = json.load(f)
    for key in ("configs", "workloads"):
        assert new[key][: len(old[key])] == old[key]
    for out in (0, 1):
        rc, stdout, stderr = toycell.run_cpu(root, ["--workload", "toy.single", "--seed",
                                                    str(2**31 + 11 + out), "--seconds", "1",
                                                    "--trace", str(out)])
        assert rc == 0, stderr[-3000:]
        line = toycell.last_json(stdout)
        assert line["correct"] and line["attempted"] >= 1 and line["failed"] == 0
        assert list(line)[-1] == "checks"
        if out:
            assert {"witness_ms.single", "assemble_ms.single", "h_pipeline_ms.single",
                    "msm_ms.single"} <= set(line["metrics"])
            assert line["device"]["window_s"] > 0
        else:
            assert set(line["metrics"]) == {"setup_s", "prove_s"}
        assert stderr.rstrip().splitlines()[-1].startswith("check ")
    rc, stdout, stderr = toycell.run_cpu(root, ["--workload", "toy.batch8", "--seed",
                                                str(2**33 + 5), "--seconds", "1", "--trace", "0"])
    assert rc == 0, stderr[-3000:]
    line = toycell.last_json(stdout)
    assert line["correct"] and line["attempted"] % 8 == 0 and line["failed"] == 0
    assert set(line["metrics"]) == {"setup_s", "proofs_per_s"}
    assert toycell.digests(ROOT) == before


def test_a_system_or_circuit_with_no_file_and_an_entry_the_system_lacks_are_refused(tmp_path):
    from types import SimpleNamespace

    from zkb import spec

    root = toycell.make_copy(str(tmp_path))
    cell = spec.load_cell("toy.single", root)
    bad = SimpleNamespace(traffic={"entry": "prove", "proofs_per_request": 2})
    with pytest.raises(ValueError):
        cell.system.program_prover(bad, None)
    with pytest.raises(ValueError):
        cell.system.program_prover(SimpleNamespace(traffic={"entry": "verify",
                                                            "proofs_per_request": 1}), None)
    for key, name in (("system", "marlin"), ("circuit", "no_such_circuit")):
        path = os.path.join(root, "zkbench", "configs", "toy.json")
        with open(path) as f:
            config = json.load(f)
        with open(path, "w") as f:
            json.dump(dict(config, **{key: name}), f)
        with pytest.raises(FileNotFoundError):
            spec.load_cell("toy.single", root)
        with open(path, "w") as f:
            json.dump(config, f)
