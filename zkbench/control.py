"""The check's control: the plain reference in the program's place, one
16-bit limb short of the scalar field the configuration states.

Each request's proofs come from ``reference/groth16_ref.py`` with every
scalar it touches (the witness, r, s and the proof's a, b, c) held in
``fr_limbs - 1`` limbs, the bits above lost: the nearest precision below
the configuration's.  Set-up, the traffic and the check are the run's own
(``zkb.loop.run``), so the check must find these proofs wrong.

  python3 zkbench/control.py --workload <cell> --seeds 11,12,13 [--requests N]

prints one JSON line a seed: the cell, the seed, ``correct`` and the
numbers compared.  The benchmark's runs never run it; the card test
``zkbench/tests/test_zkbench_control.py`` does.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for p in (ROOT, HERE):
    if p not in sys.path:
        sys.path.insert(0, p)

from reference.groth16_ref import truncate  # noqa: E402
from zkb import check as chk  # noqa: E402


def control_prover(cell, keys, make_ref):
    """Reference proofs at one limb fewer than the configuration's
    ``fr_limbs``, drawing r and s as the program does (``rng.randrange(r)``
    twice a proof, every proof's first)."""
    ref = make_ref()
    limbs = cell.config["fr_limbs"] - 1

    def prove(css, rng, phases):
        draws = [(rng.randrange(ref.r), rng.randrange(ref.r)) for _ in css]
        out = []
        for cs, (rr, ss) in zip(css, draws):
            ws = ref.witness_scalars([truncate(int(v), limbs) for v in cs.values])
            abc = ref.proof_scalars(ws, truncate(rr, limbs), truncate(ss, limbs))
            a, b, c = ref.proof_points(*(truncate(x, limbs) for x in abc))
            out.append(SimpleNamespace(a=a, b=b, c=c))
        return out

    return prove


def run_control(workload: str, seed: int, requests: int, device: str = "cuda",
                root: str = ROOT, t0: float | None = None) -> dict:
    from zkb import loop, spec

    cell = spec.load_cell(workload, root)
    out = loop.run(cell, seed, 1e9, False, device, time.perf_counter() if t0 is None else t0,
                   make_prover=control_prover, max_requests=requests)
    return {"workload": workload, "seed": seed, "attempted": out["attempted"],
            "correct": chk.correct(out["failed"], out["numbers"]),
            "checks": {n: {"value": v, "limit": lim} for n, v, lim in out["numbers"]}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--requests", type=int, default=12)
    args = ap.parse_args(argv)
    for s in args.seeds.split(","):
        print(json.dumps(run_control(args.workload, int(s), args.requests)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
