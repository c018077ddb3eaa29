"""Time untraced prove_lm proofs of one or more package roots in turns, on one H100.

    python3 tools/time_prove.py [--reps N] [ROOT ...]

For each package root (default: this checkout), in a subprocess of its
own, it loads ``zkmember_tpu_torch`` from ROOT and the committed 16-member
key (``artifacts/groth16_bls12_381_16.*``), builds the kernels, warms the
key, runs one warm-up proof of ``chip_smoke.py``'s membership circuit and
then N untraced proofs (default 20), each timed on the host clock with
the card synchronized before it and after it, and the kernels' launches
counted over the last.  Prints one JSON line a root: the seconds of each
proof, their median and quartiles, the launches, the card and its power
limit.  Pass an unpacked parent and this checkout in turns (A B B A) to
compare two trees on one card.
"""
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(root: str, reps: int) -> dict:
    import importlib.util

    sys.path.insert(0, root)
    import torch

    # this checkout's chip_smoke.py builds the circuit, whichever package root is measured
    spec_cs = importlib.util.spec_from_file_location("chip_smoke",
                                                     os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec_cs)
    spec_cs.loader.exec_module(cs)
    from zkmember_tpu_torch import kernels
    from zkmember_tpu_torch.snark import prove_lm
    from zkmember_tpu_torch.utils import checkpoint

    if not kernels.__file__.startswith(root):
        raise RuntimeError(f"loaded {kernels.__file__}, not the package under {root}")
    if os.environ.get("ZKMEMBER_TRACE"):
        raise RuntimeError("unset ZKMEMBER_TRACE: this times untraced proofs")
    circuit, _, rng = cs._membership_circuit(16)
    keys = checkpoint.load_groth16_keys(os.path.join(REPO, "artifacts", "groth16_bls12_381_16"),
                                        device="cuda")
    prove_lm.warm(keys)
    prove_lm.prove(keys, circuit, rng=rng)
    seconds = []
    for _ in range(reps):
        kernels.reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        prove_lm.prove(keys, circuit, rng=rng)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t)
    q1, median, q3 = statistics.quantiles(seconds, n=4)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    return {"root": root, "smi": smi, "reps": reps, "median_s": median, "q1_s": q1, "q3_s": q3,
            "seconds": seconds, "launches": {k: v for k, v in kernels.LAUNCHES.items() if v}}


if __name__ == "__main__":
    args = sys.argv[1:]
    reps = 20
    if args[:1] == ["--reps"]:
        reps, args = int(args[1]), args[2:]
    if args[:1] == ["--one"]:
        print(json.dumps(run(os.path.abspath(args[1]), reps)), flush=True)
    else:
        for root in args or [REPO]:
            subprocess.run([sys.executable, os.path.abspath(__file__), "--reps", str(reps),
                            "--one", root], check=True, timeout=1200)
