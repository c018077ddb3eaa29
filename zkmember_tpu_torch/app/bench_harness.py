"""Benchmark harness on the PyTorch/CUDA port (counterpart of
zkmember_tpu.app.bench_harness): the reference's Criterion grid.

Per (curve stack, proving system, registrar size): build the tree, pick a
random member, time prove and verify; row names follow the reference's
``{curve}_{system}_{phase}_{n}`` convention, one JSON line each.

- ``--systems groth16`` (default): the limb-major prover (``prove_lm``);
  setup is timed too, or the key is loaded from ``--checkpoint-dir``.
  ``--batch P`` times P proofs of members of one registrar through
  ``prove_lm.prove_batch`` and reports proofs/sec.
- ``--systems marlin``: universal setup plus index (row ``setup+index``),
  then prove and verify (``snark.marlin``), per size.  With
  ``--universal``, ONE SRS and ONE index at the largest size serve every
  size, each registrar padded to the largest with default members (rows
  ``marlin_universal``).  No Marlin SRS or index is saved.

Both stacks: ``--stack pedersen381`` (BLS12-381) and ``--stack
pedersen761`` (BW6-761).  ``--device`` (default cuda) says where the
members are hashed (``Member.hash_batch``), the tree is built (on the
device above 64 leaves), and setup and the provers run; ``cpu`` runs the
kernels' plain versions.

Run: python -m zkmember_tpu_torch.app.bench_harness --sizes 16 --checkpoint-dir artifacts
     python -m zkmember_tpu_torch.app.bench_harness --systems marlin --universal --sizes 4,16
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import time
from typing import NamedTuple

from zkmember_tpu_torch.app import circuits as app
from zkmember_tpu_torch.app.member import Member, generate_members
from zkmember_tpu_torch.snark import groth16, marlin, prove_lm
from zkmember_tpu_torch.utils import checkpoint
from zkmember_tpu_torch.utils import rng as frng

# the reference's registrar sizes (benches/groth16.rs:9-20)
DEFAULT_SIZES = [16, 50, 64, 100, 128, 512, 1000, 1024]
CURVES = {"pedersen381": "bls12_381", "pedersen761": "bw6_761"}


class Registrar(NamedTuple):
    cfg: app.StackConfig
    leaf_params: object
    node_params: object
    digests: list  # the members' leaf digests
    tree: object


def _registrar(stack: str, n_members: int, pad_to: int | None = None,
               device=None) -> Registrar:
    """The mock registrar of `n_members`, its CRH parameters from the test
    rng, its members hashed in one batch and its tree built on `device`
    (the card unless "cpu"; the tree hashes there above 64 leaves); with
    `pad_to` (Marlin's universal mode) padded to that many leaves with the
    default member's digest, a host hash as in the reference."""
    cfg = app.get_config(stack)
    leaf_params, node_params = cfg.setup_params(frng.test_rng())
    digests = Member.hash_batch(leaf_params, generate_members(n_members), device)
    if pad_to is not None and len(digests) < pad_to:
        digests += [Member.default().hash(leaf_params)] * (pad_to - len(digests))
    tree = app.new_membership_tree(leaf_params, node_params, digests, device)
    return Registrar(cfg, leaf_params, node_params, digests, tree)


def _circuit(reg: Registrar, idx: int):
    """The constraint system of member `idx`'s membership proof."""
    circuit = app.MerkleTreeCircuit(
        config=reg.cfg, leaf_params=reg.leaf_params, node_params=reg.node_params,
        root=reg.tree.root(), leaf_hash=reg.digests[idx],
        authentication_path=reg.tree.generate_proof(idx),
    )
    return circuit.generate_constraints()


def _build(stack: str, n_members: int, pad_to: int | None = None, device=None):
    """(constraint system, root, leaf) of a random member's proof."""
    reg = _registrar(stack, n_members, pad_to, device)
    idx = random.Random(0).randrange(n_members)
    return _circuit(reg, idx), reg.tree.root(), reg.digests[idx]


def _timed_reps(fn, reps: int):
    """reps wall times -> (last_result, [seconds...])."""
    times, result = [], None
    for _ in range(reps):
        t0 = time.time()
        result = fn()
        times.append(time.time() - t0)
    return result, times


def _median(xs):
    s = sorted(xs)
    m = len(s) // 2
    return s[m] if len(s) % 2 else (s[m - 1] + s[m]) / 2


def _keys(cs, curve: str, n: int, rng, device, checkpoint_dir, out):
    """The proving key for `cs`: loaded from `<dir>/groth16_<curve>_<n>` when
    it exists (row `setup_load`), else made by setup (row `setup`) and saved
    there when a directory is given."""
    ck = os.path.join(checkpoint_dir, f"groth16_{curve}_{n}") if checkpoint_dir else None
    if ck and os.path.exists(ck + ".json"):
        t0 = time.time()
        keys = checkpoint.load_groth16_keys(ck, device=device)
        if out:
            out(_row(curve, "groth16", "setup_load", n, time.time() - t0, cs, note="checkpoint"))
        return keys
    t0 = time.time()
    pk, _ = groth16.setup(cs, curve=curve, rng=rng, device=device)
    if out:
        out(_row(curve, "groth16", "setup", n, time.time() - t0, cs, note="cold"))
    if ck:
        os.makedirs(checkpoint_dir, exist_ok=True)
        checkpoint.save_groth16_keys(ck, pk)
    return prove_lm.Groth16KeysLM(pk, device)


def bench_groth16(stack: str, sizes, reps: int = 5, out=print, checkpoint_dir=None,
                  device=None):
    """Groth16 grid on the limb-major prover: per size, `reps` timed proves
    after one warm-up, every rep plus {min, median}; verify likewise (at
    least 3 reps)."""
    curve = CURVES[stack]
    rng = frng.test_rng()
    for n in sizes:
        cs, root, leaf = _build(stack, n, device=device)
        keys = _keys(cs, curve, n, rng, device, checkpoint_dir, out)
        prove_lm.warm(keys)
        prove_lm.prove(keys, cs, rng=rng)  # warm-up
        proof, times = _timed_reps(lambda: prove_lm.prove(keys, cs, rng=rng), reps)
        for t in times:
            out(_row(curve, "groth16", "prove", n, t, cs))
        out(_row(curve, "groth16", "prove", n, min(times), cs,
                 stats={"min": round(min(times), 4),
                        "median": round(_median(times), 4), "reps": reps}))
        ok, vtimes = _timed_reps(
            lambda: groth16.verify(keys.pk.vk, [root, leaf], proof), max(reps, 3))
        out(_row(curve, "groth16", "verify", n, min(vtimes), cs, ok=ok,
                 stats={"min": round(min(vtimes), 4),
                        "median": round(_median(vtimes), 4), "reps": len(vtimes)}))
        if not ok:
            raise RuntimeError(f"the {n}-member proof does not verify")


def bench_groth16_batch(stack: str, n_members: int, batch: int, reps: int = 3, out=print,
                        checkpoint_dir=None, device=None):
    """Batched proving throughput (proofs/sec): `batch` members of ONE
    registrar prove through ``prove_lm.prove_batch`` (one H pipeline, one K1
    launch and one finish per MSM family for all of them), sharing the key
    and its Straus tables."""
    curve = CURVES[stack]
    rng = frng.test_rng()
    reg = _registrar(stack, n_members, device=device)
    idxs = [random.Random(i).randrange(n_members) for i in range(batch)]
    cs_list = [_circuit(reg, idx) for idx in idxs]
    keys = _keys(cs_list[0], curve, n_members, rng, device, checkpoint_dir, None)
    prove_lm.warm(keys)
    proofs = prove_lm.prove_batch(keys, cs_list, rng=rng)  # warm-up
    proofs, times = _timed_reps(lambda: prove_lm.prove_batch(keys, cs_list, rng=rng), reps)
    best = min(times)
    for idx, proof in zip(idxs, proofs):
        if not groth16.verify(keys.pk.vk, [reg.tree.root(), reg.digests[idx]], proof):
            raise RuntimeError(f"the batched proof of member {idx} does not verify")
    out(_row(curve, "groth16_batch", "prove", n_members, best, cs_list[0], ok=True,
             stats={"batch": batch, "proofs_per_sec": round(batch / best, 3),
                    "median": round(_median(times), 4), "reps": reps}))


def _nnz(cs) -> int:
    """The largest non-zero count of A, B and C (Marlin's |K| before padding)."""
    return max(sum(len(lc) for lc in m) for m in (cs.A, cs.B, cs.C))


def bench_marlin(stack: str, sizes, universal: bool = False, reps: int = 3, out=print,
                 device=None):
    """Marlin grid, the reference's protocol (no warm-up): per size, setup
    plus index timed once, then `reps` proves and `reps` verifies.  With
    `universal`, one SRS and one index at the largest size serve every
    size, each registrar padded to it with default members."""
    curve = CURVES[stack]
    rng = frng.test_rng()

    def prove_and_verify(system, n, cs, root, leaf, ipk, ivk, each):
        proof, times = _timed_reps(lambda: marlin.prove(ipk, cs, rng=rng, device=device), reps)
        if each:
            for t in times:
                out(_row(curve, system, "prove", n, t, cs))
        out(_row(curve, system, "prove", n, min(times), cs,
                 stats={"min": round(min(times), 4),
                        "median": round(_median(times), 4), "reps": reps}))
        ok, vtimes = _timed_reps(lambda: marlin.verify(ivk, [root, leaf], proof), reps)
        out(_row(curve, system, "verify", n, min(vtimes), cs, ok=ok,
                 stats={"min": round(min(vtimes), 4),
                        "median": round(_median(vtimes), 4), "reps": reps}))
        if not ok:
            raise RuntimeError(f"the {n}-member Marlin proof does not verify")

    def setup_index(system, n, cs):
        t0 = time.time()
        pp = marlin.universal_setup(cs.num_constraints, cs.num_variables, _nnz(cs),
                                    curve=curve, rng=rng, device=device)
        ipk, ivk = marlin.index(pp, cs, device=device)
        out(_row(curve, system, "setup+index", n, time.time() - t0, cs))
        return ipk, ivk

    if universal:
        max_n = max(sizes)
        ipk, ivk = setup_index("marlin_universal", max_n, _build(stack, max_n, device=device)[0])
        for n in sizes:
            cs, root, leaf = _build(stack, n, pad_to=max_n, device=device)
            prove_and_verify("marlin_universal", n, cs, root, leaf, ipk, ivk, each=False)
        return
    for n in sizes:
        cs, root, leaf = _build(stack, n, device=device)
        ipk, ivk = setup_index("marlin", n, cs)
        prove_and_verify("marlin", n, cs, root, leaf, ipk, ivk, each=True)


def _row(curve, system, phase, n, seconds, cs, ok=None, note=None, stats=None):
    row = {
        "name": f"{curve}_{system}_{phase}_{n}",
        "seconds": round(seconds, 4),
        "constraints": cs.num_constraints,
        "variables": cs.num_variables,
    }
    if ok is not None:
        row["verified"] = bool(ok)
    if note:
        row["note"] = note
    if stats:
        row.update(stats)
    return json.dumps(row)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--stack", default="pedersen381", choices=sorted(CURVES))
    ap.add_argument("--sizes", default="16")
    ap.add_argument("--systems", default="groth16")
    ap.add_argument("--universal", action="store_true")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--batch", type=int, default=0,
                    help="batched-proving throughput mode: prove this many "
                    "members of one registrar via prove_batch (proofs/sec)")
    ap.add_argument("--device", default="cuda",
                    help="where hashing, setup and the prover run (default cuda; cpu "
                         "runs the kernels' plain versions)")
    args = ap.parse_args(argv)
    sizes = [int(s) for s in args.sizes.split(",")]
    if args.batch:
        bench_groth16_batch(args.stack, sizes[0], args.batch, reps=args.reps,
                            checkpoint_dir=args.checkpoint_dir, device=args.device)
        return 0
    for system in args.systems.split(","):
        if system == "groth16":
            bench_groth16(args.stack, sizes, reps=args.reps, checkpoint_dir=args.checkpoint_dir,
                          device=args.device)
        elif system == "marlin":
            bench_marlin(args.stack, sizes, universal=args.universal, reps=args.reps,
                         device=args.device)
        else:
            print(f"unknown system {system}", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
