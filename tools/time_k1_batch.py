"""Time kernel K1 at the batched prover's shapes, on one H100.

    python3 tools/time_k1_batch.py [ROOT]

Loads ``zkmember_tpu_torch`` from ROOT (default: this checkout), builds its
kernels, proves batches of 4 and 8 distinct members of the 16-member
registrar from the committed key to capture K1's real digits, then prints
one JSON line: K1's milliseconds (20 launches between CUDA events, the
median of 5 rounds) for G1 (fp) and G2 (fp2) at P = 4 and 8, on random
digits and on the real ones, the share of real digits that are 0, and a
limb-for-limb check against the plain version at the real batch of 4.
To compare two designs of the kernel, copy the package into a git-ignored
directory, change the kernel there, and run this script on both roots in
turns in one call (A, B, B, A)."""
import json
import os
import random
import statistics
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else REPO)
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from zkmember_tpu_torch import kernels  # noqa: E402
from zkmember_tpu_torch.app import circuits as app  # noqa: E402
from zkmember_tpu_torch.app.member import generate_members  # noqa: E402
from zkmember_tpu_torch.msm import select_reduce_cuda as k1  # noqa: E402
from zkmember_tpu_torch.snark import prove_lm  # noqa: E402
from zkmember_tpu_torch.utils import checkpoint, rng as frng  # noqa: E402

assert kernels.__file__.startswith(ROOT), kernels.__file__
t0 = time.time()
kernels.library()
build_s = time.time() - t0


def cuda_ms(fn, reps=20, rounds=5):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


keys = checkpoint.load_groth16_keys(os.path.join(REPO, "artifacts", "groth16_bls12_381_16"),
                                    device="cuda")
prove_lm.warm(keys)
cfg = app.get_config("pedersen381")
lp, np_ = cfg.setup_params(frng.test_rng())
digests = [m.hash(lp) for m in generate_members(16)]
tree = app.new_membership_tree(lp, np_, digests)
idxs = random.Random(1).sample(range(16), 8)
cs_all = []
for i in idxs:
    c = app.MerkleTreeCircuit(config=cfg, leaf_params=lp, node_params=np_, root=tree.root(),
                              leaf_hash=digests[i], authentication_path=tree.generate_proof(i))
    cs_all.append(c.generate_constraints())

orig = k1.select_reduce_cuda
captured = {}


def capture(ops, tab, digits):
    captured[(isinstance(ops.b3, tuple), digits.shape[1])] = digits.clone()
    return orig(ops, tab, digits)


k1.select_reduce_cuda = capture
for P in (4, 8):
    prove_lm.prove_batch(keys, cs_all[:P], rng=frng.test_rng())
k1.select_reduce_cuda = orig

np_rng = np.random.default_rng(0)
out = {"root": ROOT, "build_s": build_s}
for g2 in (False, True):
    ops, tab = (keys.ops2, keys.g2_tab) if g2 else (keys.ops1, keys.g1_tab)
    name = "fp2" if g2 else "fp"
    for P in (4, 8):
        real = captured[(g2, P)]
        rnd = torch.as_tensor(np_rng.integers(0, 16, size=tuple(real.shape)), dtype=torch.int32,
                              device="cuda")
        for label, dig in (("random", rnd), ("real", real)):
            out[f"{name}_P{P}_{label}"] = cuda_ms(lambda: k1.select_reduce_cuda(ops, tab, dig))
        zero = float((real == 0).float().mean())
        out[f"{name}_P{P}_real_zero_digit_share"] = zero
    # limb-exact at the real batch of 4 (plain over two-window slices)
    dig = captured[(g2, 4)]
    got = k1.select_reduce_cuda(ops, tab, dig)
    for w in range(0, dig.shape[0], 2):
        want = k1.select_reduce_plain(ops, tab, dig[w : w + 2])
        flat = lambda S: [c for x in S for c in (x if isinstance(x, tuple) else (x,))]  # noqa
        assert all(torch.equal(a[w : w + 2], b) for a, b in zip(flat(got), flat(want))), (name, w)
    out[f"{name}_P4_real_exact"] = True
print(json.dumps(out))
