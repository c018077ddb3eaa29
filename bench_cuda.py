"""Headline benchmark on the PyTorch/CUDA port: one Groth16 BLS12-381
membership proof, timed (the counterpart of bench.py).

The same protocol as bench.py (the reference's benches/groth16.rs:49-137):
build the registrar's tree, pick a random member, build its path and
circuit, load the proving key or run setup once, then time one proof.  The
registrar size comes from $BENCH_MEMBERS (default 16; the reference sweeps
16, 50, 64, 100, 128, 512, 1000 and 1024 members).

  * The key is read from <checkpoint_dir>/groth16_bls12_381_{n}.{json,npz}
    (default artifacts/); where it is missing, setup runs on the device and
    the key is saved there for the next run.
  * The member digests hash on the host, as in bench.py; the tree hashes on
    the host up to 64 leaves and on the device above (the reference's rule,
    merkle/tree.py): host at 16 and 64 members, the card at 128 and 1,024.
  * The prover is the limb-major stack (snark/prove_lm.py) over the
    hand-written CUDA kernels, built by ``prove_lm.warm``.

Progress goes to stderr as ``# [<s>s] <step>`` lines.  stdout's last line is
one JSON object:
  {"metric": ..., "value": seconds, "unit": "s", "vs_baseline": speedup,
   "device": "<name>, <power limit>" (nvidia-smi) or "cpu"}
vs_baseline = reference_seconds / ours (>1 = faster than the reference's
MacBook Pro numbers, report.pdf p6 Fig 7).

Run on the card:  python3 bench_cuda.py          (BENCH_MEMBERS=64 python3 bench_cuda.py)
Without a card it raises; only a caller of main(device="cpu") gets the
kernels' plain PyTorch versions on the CPU.
"""

from __future__ import annotations

import json
import os
import random
import subprocess
import sys
import time

import torch

from zkmember_tpu_torch import device as devmod
from zkmember_tpu_torch.app import circuits as app
from zkmember_tpu_torch.app.member import generate_members
from zkmember_tpu_torch.merkle.tree import HOST_MAX_LEAVES
from zkmember_tpu_torch.snark import groth16, prove_lm
from zkmember_tpu_torch.utils import checkpoint
from zkmember_tpu_torch.utils import rng as frng

REPO = os.path.dirname(os.path.abspath(__file__))

# report.pdf p6 Fig 7 (MacBook Pro): ~300 ms at 16 -> ~620 ms at 1024 (bench.py:44-45)
BASELINE_S = {16: 0.300, 50: 0.380, 64: 0.400, 100: 0.450, 128: 0.470,
              512: 0.560, 1000: 0.620, 1024: 0.620}


def member_index(members: int) -> int:
    """The member whose proof the bench times (bench.py's draw)."""
    return random.Random(0).randrange(members)


def membership_tree(leaf_params, node_params, people, device=None):
    """The members' leaf digests (hashed on the host, as bench.py does) and
    the registrar's tree (on the host up to 64 leaves, else on `device`)."""
    digests = [m.hash(leaf_params) for m in people]
    return digests, app.new_membership_tree(leaf_params, node_params, digests, device)


def member_circuit(cfg, leaf_params, node_params, digests, tree, idx: int):
    """Member idx's membership circuit as a constraint system, and its public
    inputs [root, leaf digest]."""
    circuit = app.MerkleTreeCircuit(
        config=cfg, leaf_params=leaf_params, node_params=node_params,
        root=tree.root(), leaf_hash=digests[idx], authentication_path=tree.generate_proof(idx),
    )
    return circuit.generate_constraints(), [tree.root(), digests[idx]]


def device_label(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi reports them, or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def result_line(members: int, prove_s: float, device: str) -> dict:
    """bench.py's JSON line (bench.py:114-119) plus the device it ran on."""
    value = round(prove_s, 4)
    return {
        "metric": f"groth16_bls12_381_prove_{members}members",
        "value": value,
        "unit": "s",
        "vs_baseline": round(BASELINE_S.get(members, 0.300) / value, 3),
        "device": device,
    }


def main(members: int | None = None, device=None, checkpoint_dir: str | None = None) -> dict:
    """Run the bench at `members` (default 16) on `device` (default the
    card; "cpu" runs the plain versions), the key read from or saved to
    `checkpoint_dir` (default artifacts/).  Prints the result line and
    returns it with ``setup_s`` (None where the key was loaded) and the
    key's domain ``M`` added."""
    members = 16 if members is None else int(members)
    dev = devmod.resolve(device)  # raises without a card unless device="cpu"
    checkpoint_dir = checkpoint_dir or os.path.join(REPO, "artifacts")

    t0 = time.time()

    def mark(msg):
        print(f"# [{time.time() - t0:7.1f}s] {msg}", file=sys.stderr, flush=True)

    rng = frng.test_rng()
    cfg = app.get_config("pedersen381")
    leaf_params, node_params = cfg.setup_params(rng)
    mark("pedersen params")

    digests, tree = membership_tree(leaf_params, node_params, generate_members(members), dev)
    idx = member_index(members)
    where = "host" if len(tree.levels[0]) <= HOST_MAX_LEAVES else dev.type
    cs, public = member_circuit(cfg, leaf_params, node_params, digests, tree, idx)
    mark(f"tree depth {tree.depth} ({where}) + path + circuit: {cs.num_constraints} "
         f"constraints, {cs.num_variables} vars, {len(cs.boolean_vars)} boolean")

    ck = os.path.join(checkpoint_dir, f"groth16_bls12_381_{members}")
    setup_s = None
    if os.path.exists(ck + ".json"):
        keys = checkpoint.load_groth16_keys(ck, dev)
        mark("proving key loaded from checkpoint")
    else:
        t1 = time.time()
        pk, _ = groth16.setup(cs, "bls12_381", rng, device=dev)
        setup_s = time.time() - t1
        mark("groth16 setup (cold)")
        os.makedirs(checkpoint_dir, exist_ok=True)
        checkpoint.save_groth16_keys(ck, pk)
        mark("proving key checkpointed")
        keys = prove_lm.Groth16KeysLM(pk, dev)
    vk = keys.pk.vk
    mark("limb-major key planes resident")

    prove_lm.warm(keys, verbose=True)
    mark("kernels built and Straus tables resident")

    # warm-up proof (everything resident), then the timed proof; prove returns
    # after its device -> host fetch and the host assembly, so the host clock
    # covers all of the card's work
    prove_lm.prove(keys, cs, rng=rng)
    mark("prove warm-up")
    t1 = time.time()
    proof = prove_lm.prove(keys, cs, rng=rng)
    prove_s = time.time() - t1
    mark(f"prove: {prove_s:.3f}s")

    if not groth16.verify(vk, public, proof):
        raise RuntimeError("the proof does not verify")
    mark("verified")

    out = result_line(members, prove_s, device_label(dev))
    print(json.dumps(out), flush=True)
    return dict(out, setup_s=setup_s, M=keys.M)


if __name__ == "__main__":
    main(int(os.environ.get("BENCH_MEMBERS", "16")))
