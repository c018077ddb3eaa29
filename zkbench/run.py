"""Run one cell of the benchmark on the card and print its result line.

  python3 zkbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell ``<config>.<traffic>`` is resolved
by the names in BENCHMARK.json (``zkb.spec``): its configuration file, its
traffic mix ``zkbench/traffic/<traffic>.json`` and one reader a metric,
``zkbench/metrics/<metric>.py``.  A later cell, mix or metric is new files
and new entries there.  The host's thread settings and the checkout's
cache directories come from ``zkbench/host.json``, set before PyTorch is
imported.  With ``--trace 0`` the line's metrics are the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics, ``device.busy_s``,
``device.window_s`` and ``breakdown``.  The numbers the check compared go
to stderr as the last lines, and into the line under ``checks``, its last
key.  Without a card, or with fewer cards than the cell asks for, it exits
with 3 and prints no line; with JAX or the JAX package loaded, 4.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for p in (ROOT, HERE):
    if p not in sys.path:
        sys.path.insert(0, p)

FORBIDDEN = ("jax", "jaxlib", "flax", "zkmember_tpu")


def forbidden_modules(modules) -> list:
    """Loaded modules whose top-level name (before the first dot) is JAX's
    or the JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def host_settings(root: str = ROOT) -> dict:
    """Apply ``zkbench/host.json``: its environment, and its cache
    directories at fixed paths inside the checkout."""
    with open(os.path.join(root, "zkbench", "host.json")) as f:
        host = json.load(f)
    os.environ.update(host["environment"])
    for name, rel in host["caches_in_checkout"].items():
        os.environ[name] = os.path.join(root, rel)
    return host


def result_line(cell, out: dict, trace: bool, device: dict) -> dict:
    from zkb import check

    run = out["run"]
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = m.reader.read(run)
        if v is not None:
            metrics[m.name] = {"value": v, "unit": m.unit}
    line = {
        "correct": check.correct(out["failed"], out["numbers"]),
        "attempted": out["attempted"],
        "failed": out["failed"],
        "metrics": metrics,
        "device": device,
    }
    if trace:
        from zkb import trace as tr

        t = run.trace
        lo, hi = t["window"]
        device["busy_s"] = tr.busy(t["device"], lo, hi)
        device["window_s"] = hi - lo
        line["breakdown"] = tr.breakdown(t)
    line["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in out["numbers"]}
    return line


def main(argv=None, device: str = "cuda") -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    host = host_settings()

    import torch

    from zkb import loop, spec

    if device == "cuda":  # a measured run; tests on the CPU keep their caller's threads
        torch.set_num_threads(host["torch_threads"])
    cell = spec.load_cell(args.workload)
    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < cell.chips):
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"zkbench: {args.workload} needs {cell.chips} CUDA device(s); {n} available",
              file=sys.stderr)
        return 3
    out = loop.run(cell, args.seed, args.seconds, bool(args.trace), device, T0)
    dev = torch.device(device)
    info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": out["peak"],
    }
    line = result_line(cell, out, bool(args.trace), info)
    found = forbidden_modules(sys.modules)
    if found:
        print(f"zkbench: loaded in the run's process: {', '.join(found)}", file=sys.stderr)
        return 4
    for name, v, lim in out["numbers"]:
        print(f"check {name} {v} limit {lim}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
