"""Scale configurations on the PyTorch/CUDA port: depth-32 membership
proving (counterpart of zkmember_tpu.app.scale).

A depth-32 membership circuit has about 100k constraints (domain 2^17).
The circuit only consumes an authentication path, so a random depth-32
path and the root it hashes up to (on the host) are a valid witness of the
exact circuit a 2^32-member registrar would give.  No depth-32 key is
committed: setup makes it on the device, or it is loaded from (and saved
to) ``--checkpoint-dir``.

Run:  python -m zkmember_tpu_torch.app.scale [--depth 32] [--batch 1]
          [--checkpoint-dir DIR] [--device cuda|cpu]
Emits one JSON line per phase (trace, setup or load_keys, keys+warm,
first_prove, prove, verify, total).
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import time

from zkmember_tpu_torch.app import circuits as app
from zkmember_tpu_torch.hash import pedersen as ph
from zkmember_tpu_torch.merkle.tree import MerklePath
from zkmember_tpu_torch.r1cs import gadgets as g
from zkmember_tpu_torch.r1cs.cs import ConstraintSystem
from zkmember_tpu_torch.snark import groth16, prove_lm
from zkmember_tpu_torch.utils import checkpoint
from zkmember_tpu_torch.utils import rng as frng


def synthetic_path(cfg, leaf_params, node_params, depth: int, seed: int = 0):
    """(root, leaf_digest, MerklePath) for a random depth-`depth` branch."""
    rng = random.Random(seed)
    p = cfg.scalar_field.p
    spec_bytes = node_params.spec.n * 2
    leaf_digest = rng.randrange(p)  # the app-level member digest (public)
    # tree-level leaf hash of the app-level digest (as MerkleTree hashes it)
    cur = ph.hash_bytes_host(leaf_params, int(leaf_digest).to_bytes(spec_bytes, "little")).v
    index = rng.getrandbits(depth)
    sibs = []
    node = cur
    for lvl in range(depth):
        sib = rng.randrange(p)
        sibs.append(sib)
        left, right = (sib, node) if (index >> lvl) & 1 else (node, sib)
        node = ph.two_to_one_host(
            node_params,
            int(left).to_bytes(spec_bytes, "little"),
            int(right).to_bytes(spec_bytes, "little"),
        ).v
    return node, leaf_digest, MerklePath(leaf_index=index, siblings=sibs, leaf_digest=cur)


def scale_circuit(cfg, leaf_params, node_params, cases):
    """One constraint system proving every (root, leaf, path) of `cases`;
    returns it and its public inputs.  One case is the membership circuit
    itself; more are independent membership sub-circuits of one R1CS, all
    inputs first."""
    if len(cases) == 1:
        root, leaf_digest, path = cases[0]
        circuit = app.MerkleTreeCircuit(
            config=cfg, leaf_params=leaf_params, node_params=node_params,
            root=root, leaf_hash=leaf_digest, authentication_path=path,
        )
        return circuit.generate_constraints(), [root, leaf_digest]
    cs = ConstraintSystem(cfg.scalar_field)
    io = [(g.FpVar.new_input(cs, root), g.FpVar.new_input(cs, leaf)) for root, leaf, _ in cases]
    for (root_v, leaf_v), (_, _, path) in zip(io, cases):
        index_bits = [g.Boolean.new_witness(cs, (path.leaf_index >> i) & 1)
                      for i in range(len(path.siblings))]
        sibling_vars = [g.FpVar.new_witness(cs, s) for s in path.siblings]
        g.merkle_path_gadget(cs, leaf_params, node_params, root_v, leaf_v, index_bits,
                             sibling_vars).enforce_true()
    return cs, [v for root, leaf, _ in cases for v in (root, leaf)]


def run_depth(depth: int = 32, checkpoint_dir: str | None = None, out=print, batch: int = 1,
              device=None):
    """Trace, set up (or load), warm, prove and verify the depth-`depth`
    circuit; batch > 1 proves `batch` independent depth-`depth`
    memberships in ONE circuit.  Each phase ends with one `out` row."""
    t_all = time.time()
    tag = f"depth{depth}" + (f"_batch{batch}" if batch > 1 else "")

    def row(phase, seconds, **kw):
        out(json.dumps({"name": f"bls12_381_groth16_{tag}_{phase}",
                        "seconds": round(seconds, 3), **kw}))

    rng = frng.test_rng()
    cfg = app.get_config("pedersen381")
    leaf_params, node_params = cfg.setup_params(rng)
    cases = [synthetic_path(cfg, leaf_params, node_params, depth, seed=i) for i in range(batch)]

    t0 = time.time()
    cs, public_inputs = scale_circuit(cfg, leaf_params, node_params, cases)
    if not cs.is_satisfied():
        raise RuntimeError("the synthetic paths do not satisfy the circuit")
    row("trace", time.time() - t0, constraints=cs.num_constraints,
        variables=cs.num_variables, booleans=len(cs.boolean_vars))

    ck = os.path.join(checkpoint_dir, f"groth16_bls12_381_{tag}") if checkpoint_dir else None
    t0 = time.time()
    if ck and os.path.exists(ck + ".json"):
        keys = checkpoint.load_groth16_keys(ck, device=device)
        row("load_keys", time.time() - t0, domain=keys.M)
    else:
        pk, _ = groth16.setup(cs, curve="bls12_381", rng=rng, device=device)
        row("setup", time.time() - t0, domain=pk.domain_size)
        if ck:
            os.makedirs(checkpoint_dir, exist_ok=True)
            checkpoint.save_groth16_keys(ck, pk)
        keys = None

    t0 = time.time()
    if keys is None:
        keys = prove_lm.Groth16KeysLM(pk, device)
    prove_lm.warm(keys)
    row("keys+warm", time.time() - t0)

    t0 = time.time()
    prove_lm.prove(keys, cs, rng=rng)
    row("first_prove", time.time() - t0)
    t0 = time.time()
    proof = prove_lm.prove(keys, cs, rng=rng)
    row("prove", time.time() - t0)

    t0 = time.time()
    ok = groth16.verify(keys.pk.vk, public_inputs, proof)
    row("verify", time.time() - t0, verified=bool(ok))
    if not ok:
        raise RuntimeError(f"the depth-{depth} proof does not verify")
    row("total", time.time() - t_all)
    return keys, cs, public_inputs, proof


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--depth", type=int, default=32)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="where setup and the prover run (default cuda; cpu runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    run_depth(args.depth, args.checkpoint_dir, batch=args.batch, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
