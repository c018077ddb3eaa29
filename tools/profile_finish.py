"""Time the Straus MSM finish of one or more package roots in turns, on one H100.

    python3 tools/profile_finish.py [ROOT ...]

``chip_smoke.py`` times only the package beside it; this script compares
two designs in one call.  For each package root (default: this checkout),
in a subprocess of its own, it loads ``zkmember_tpu_torch`` from ROOT,
builds its kernels and, at the main paths' finish shapes (BLS12-381 G1 and
G2 at W = 64, depth 32's G1, BW6-761 at W = 95), times ``msm_finish_cuda`` on
random window sums with ``chip_smoke.cuda_ms`` and splits it into its two
kernels with ``chip_smoke._finish_split`` (over ``msm_finish_in_turn``
where ROOT has it, else over ``msm_finish_cuda``).  Prints one JSON line a
root, with the finish kernels' ptxas registers and spills.  Pass an
unpacked parent and this checkout in turns (A B B A).
"""
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (curve, g2, W, R, NT)
SHAPES = [("bls12_381", False, 64, 4, 1024), ("bls12_381", True, 64, 1, 1024),
          ("bls12_381", False, 64, 4, 8192), ("bw6_761", False, 95, 4, 2048),
          ("bw6_761", True, 95, 1, 2048)]


def run(root: str) -> dict:
    import importlib.util

    sys.path.insert(0, root)
    import numpy as np

    # this checkout's chip_smoke.py, whichever package root is measured
    spec_cs = importlib.util.spec_from_file_location("chip_smoke",
                                                     os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec_cs)
    spec_cs.loader.exec_module(cs)
    from zkmember_tpu_torch import kernels
    from zkmember_tpu_torch.fields import spec as fs
    from zkmember_tpu_torch.msm import finish_cuda as fin
    from zkmember_tpu_torch.snark import groth16, prove_lm

    assert kernels.__file__.startswith(root), kernels.__file__
    kernels.library()
    split_fn = getattr(fin, "msm_finish_in_turn", fin.msm_finish_cuda)
    rng = np.random.default_rng(5)
    rows = []
    for curve, g2, W, R, NT in SHAPES:
        spec = fs.BW6_FQ if curve == "bw6_761" else fs.BLS_FQ
        ops = prove_lm.sw_ops(groth16.pairing_config(curve), g2, "cuda")
        fp2 = g2 and curve == "bls12_381"
        ps = [cs.rand_planes(rng, spec, (W * R, spec.n, NT)).reshape(W, R, spec.n, NT)
              for _ in range(6 if fp2 else 3)]
        S = tuple((ps[2 * i], ps[2 * i + 1]) for i in range(3)) if fp2 else tuple(ps)
        rows.append({"curve": curve, "g2": g2, "W": W, "R": R, "NT": NT,
                     "ms": cs.cuda_ms(lambda: fin.msm_finish_cuda(ops, S), reps=5),
                     **cs._finish_split(lambda: split_fn(ops, S), 2 * 5 * (W - 1))})
        print(json.dumps(rows[-1]), file=sys.stderr, flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    return {"root": root, "smi": smi, "ptxas": cs.finish_ptxas(kernels.BUILD_LOG),
            "shapes": rows}


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--one":
        print(json.dumps(run(os.path.abspath(sys.argv[2]))), flush=True)
    else:
        for root in sys.argv[1:] or [REPO]:
            subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root], check=True,
                           timeout=1200)
