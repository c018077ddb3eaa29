"""BENCHMARK.json and the files each of its names leads to.

A cell ``<config>.<traffic>`` resolves to:
  * the configuration's ``file`` (a JSON object).  Its ``circuit`` key names
    ``zkbench/circuits/<circuit>.py``, whose ``build(config, seed, device)``
    returns the program's registrar (``curve``, ``members``,
    ``synthesize(i)``), and ``zkbench/reference/circuits/<circuit>.py``,
    whose ``publics(config, seed, members)`` re-derives the members' public
    inputs without the program.  Its ``system`` key names
    ``zkbench/systems/<system>.py``: the proof system's set-up, prover entry,
    read-back and check;
  * ``zkbench/traffic/<traffic>.json``, read by ``zkb.traffic``;
  * one reader a metric that applies to the cell: ``zkbench/metrics/<name>.py``,
    or, for a name with a variant after its first dot (``msm_ms.single``),
    ``zkbench/metrics/<name before the dot>.py``.
A metric applies to a cell unless it lists ``workloads`` without the cell.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from dataclasses import dataclass
from typing import Callable

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # zkbench/
ROOT = os.path.dirname(HERE)


def load_module(path: str, name: str):
    """A Python file as a module (file names may hold dots and dashes)."""
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # dataclasses look their module up there
    spec.loader.exec_module(mod)
    return mod


def reader_path(name: str, root: str = ROOT) -> str:
    d = os.path.join(root, "zkbench", "metrics")
    whole = os.path.join(d, name + ".py")
    return whole if os.path.isfile(whole) else os.path.join(d, name.split(".")[0] + ".py")


@dataclass
class Registrar:
    """What a configuration's circuit builder returns."""

    curve: str
    members: int
    synthesize: Callable[[int], object]  # member index -> the program's constraint system


@dataclass
class Metric:
    name: str
    unit: str
    reader: object  # module with read(run) -> float | None


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic: dict
    circuit: object  # module with build(config, seed, device)
    publics: object  # module with publics(config, seed, members): the reference's
    system: object  # module with setup, program_prover, reference, read_back, msm_rows, numbers
    end_to_end: list
    per_layer: list


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT) -> Cell:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json ({', '.join(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    c = configs[w["config"]]
    with open(os.path.join(root, c["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "zkbench", "traffic", w["traffic"] + ".json")) as f:
        traffic = json.load(f)

    def named(*parts):
        return load_module(os.path.join(root, "zkbench", *parts[:-1], parts[-1] + ".py"),
                           "zkbench_" + "_".join(parts).replace("-", "_").replace(".", "_"))

    def metrics(key):
        out = []
        for m in bench[key]:
            if _applies(m, name):
                mod = load_module(reader_path(m["name"], root),
                                  "zkbench_metric_" + m["name"].replace(".", "_").replace("-", "_"))
                out.append(Metric(m["name"], m["unit"], mod))
        return out

    return Cell(name, w["chips"], w["config"], config, traffic,
                named("circuits", config["circuit"]),
                named("reference", "circuits", config["circuit"]),
                named("systems", config["system"]),
                metrics("end_to_end"), metrics("per_layer"))
