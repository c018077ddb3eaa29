"""zkMember CLI on the PyTorch/CUDA port (counterpart of zkmember_tpu.app.cli).

register -> rebuild the tree and print the hex root; prove -> Groth16
setup, the v1 prove and verify, printing hex leaf, root, proof and vk;
verify -> parse hex root, leaf, proof and vk and run the pairing check.
The same commands and output as the reference's CLI, for both stacks
(``--stack pedersen381``, BLS12-381, the default; ``--stack pedersen761``,
BW6-761), plus ``--device`` (default ``cuda``): ``prove`` runs setup and
the prover there, and a tree above 64 leaves hashes there.  The
members live in a JSON state file (``ZKMEMBER_STATE``, default
``zkmember_state.json``).

Usage:
  python -m zkmember_tpu_torch.app.cli register --id 1 --email 1@usc.edu
  python -m zkmember_tpu_torch.app.cli root
  python -m zkmember_tpu_torch.app.cli prove --id 1
  python -m zkmember_tpu_torch.app.cli verify --root <hex> --leaf <hex> \
      --proof <hex> --vk <hex>
  python -m zkmember_tpu_torch.app.cli interactive
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys

from zkmember_tpu_torch.app import circuits as app
from zkmember_tpu_torch.app.member import Member
from zkmember_tpu_torch.snark import groth16
from zkmember_tpu_torch.utils import rng as frng
from zkmember_tpu_torch.utils import serialize as ser

BLUE, GREEN, GRAY, RED, RESET = "\x1b[0;34m", "\x1b[0;32m", "\x1b[0;90m", "\x1b[0;31m", "\x1b[0m"
CURVES = {"pedersen381": "bls12_381", "pedersen761": "bw6_761"}


def _state_file() -> str:
    return os.environ.get("ZKMEMBER_STATE", "zkmember_state.json")


def _load_state() -> list[Member]:
    if not os.path.exists(_state_file()):
        return []
    with open(_state_file()) as f:
        return [Member.from_json(json.dumps(m)) for m in json.load(f)]


def _save_state(members: list[Member]):
    with open(_state_file(), "w") as f:
        json.dump([json.loads(m.to_json()) for m in members], f, indent=1)


@functools.cache
def _params(curve_stack: str):
    """The stack's CRH parameters from the fixed test rng (deterministic, so
    one process samples them once)."""
    cfg = app.get_config(curve_stack)
    leaf_params, node_params = cfg.setup_params(frng.test_rng())
    return cfg, leaf_params, node_params


def _build_tree(leaf_params, node_params, members, device):
    """Member leaves are host hashes, as in the reference's CLI; the tree
    hashes above 64 leaves on `device`."""
    digests = [m.hash(leaf_params) for m in members]
    return app.new_membership_tree(leaf_params, node_params, digests, device), digests


def cmd_register(args):
    members = _load_state()
    members.append(Member.new(args.id, args.email))
    _save_state(members)
    _, leaf_params, node_params = _params(args.stack)
    tree, _ = _build_tree(leaf_params, node_params, members, args.device)
    print(f"{BLUE}Number of Members: {len(members)}{RESET}")
    print(f"{GREEN}Merkle Root: {tree.root():#066x}{RESET}")


def cmd_root(args):
    members = _load_state()
    if not members:
        print("no members registered", file=sys.stderr)
        return 1
    _, leaf_params, node_params = _params(args.stack)
    tree, _ = _build_tree(leaf_params, node_params, members, args.device)
    print(f"{tree.root():#x}")


def cmd_prove(args):
    members = _load_state()
    idx = next((i for i, m in enumerate(members) if m.id == args.id), None)
    if idx is None:
        print(f"member id {args.id!r} not found", file=sys.stderr)
        return 1
    cfg, leaf_params, node_params = _params(args.stack)
    tree, digests = _build_tree(leaf_params, node_params, members, args.device)
    root = tree.root()
    circuit = app.MerkleTreeCircuit(
        config=cfg, leaf_params=leaf_params, node_params=node_params,
        root=root, leaf_hash=digests[idx], authentication_path=tree.generate_proof(idx),
    )
    cs = circuit.generate_constraints()
    rng = frng.test_rng()
    pk, vk = groth16.setup(cs, curve=CURVES[args.stack], rng=rng, device=args.device)
    proof = groth16.prove(pk, cs, rng=rng, device=args.device)
    ok = groth16.verify(vk, [root, digests[idx]], proof)
    print(f"{GRAY}Leaf:{RESET}  {digests[idx]:#x}")
    print(f"{GRAY}Root:{RESET}  {root:#x}")
    print(f"{GRAY}Proof:{RESET} {ser.proof_to_bytes(proof).hex()}")
    print(f"{GRAY}VK:{RESET}    {ser.vk_to_bytes(vk).hex()}")
    print(f"{GREEN}Inline verification: {ok}{RESET}")
    return 0 if ok else 1


def cmd_verify(args):
    curve = CURVES[args.stack]
    proof = ser.proof_from_bytes(curve, bytes.fromhex(args.proof))
    vk = ser.vk_from_bytes(curve, bytes.fromhex(args.vk))
    ok = groth16.verify(vk, [int(args.root, 16), int(args.leaf, 16)], proof)
    print(f"{GREEN if ok else RED}Verification: {ok}{RESET}")
    return 0 if ok else 1


def cmd_interactive(args):
    """The reference's dialoguer loop, reading plain lines from stdin."""
    while True:
        print(f"{BLUE}zkMember — choose an action:{RESET}")
        print(" [1] register member\n [2] generate proof\n [3] verify proof\n [q] quit")
        choice = input("> ").strip()
        if choice == "1":
            args.id = input("id> ").strip()
            args.email = input("email> ").strip()
            cmd_register(args)
        elif choice == "2":
            args.id = input("member id> ").strip()
            cmd_prove(args)
        elif choice == "3":
            args.root = input("root hex> ").strip()
            args.leaf = input("leaf hex> ").strip()
            args.proof = input("proof hex> ").strip()
            args.vk = input("vk hex> ").strip()
            cmd_verify(args)
        elif choice in ("q", "quit", "exit"):
            return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="zkmember")
    ap.add_argument("--stack", default="pedersen381", choices=sorted(CURVES))
    ap.add_argument("--device", default="cuda",
                    help="where setup, the prover and a tree above 64 leaves run "
                         "(default cuda; cpu runs the kernels' plain versions)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("register")
    p.add_argument("--id", required=True)
    p.add_argument("--email", required=True)
    sub.add_parser("root")
    p = sub.add_parser("prove")
    p.add_argument("--id", required=True)
    p = sub.add_parser("verify")
    for f in ("root", "leaf", "proof", "vk"):
        p.add_argument(f"--{f}", required=True)
    sub.add_parser("interactive")
    args = ap.parse_args(argv)
    return {
        "register": cmd_register,
        "root": cmd_root,
        "prove": cmd_prove,
        "verify": cmd_verify,
        "interactive": cmd_interactive,
    }[args.cmd](args) or 0


if __name__ == "__main__":
    sys.exit(main())
