"""The port's CLI (python -m zkmember_tpu_torch.app.cli) on the CPU.

register and root run through cli.main with a temporary state file, for
both stacks (pedersen381 and pedersen761), and the root equals the one
the JAX package's membership tree gives for the same members.  verify accepts a serialised proof of a toy circuit whose
public inputs are (root, leaf) and rejects a wrong leaf.  prove at
registrar size runs on the card (chip_smoke.py's cli phase).
"""

import json

import pytest
import torch

from zkmember_tpu.app import circuits as japp
from zkmember_tpu.app.member import Member as JMember
from zkmember_tpu.utils import rng as jrng
from zkmember_tpu_torch.app import cli
from zkmember_tpu_torch.curves import bls12_381 as bls, bw6_761 as bw6
from zkmember_tpu_torch.r1cs import gadgets as g
from zkmember_tpu_torch.r1cs.cs import ConstraintSystem
from zkmember_tpu_torch.snark import groth16, prove_lm
from zkmember_tpu_torch.utils import rng as frng
from zkmember_tpu_torch.utils import serialize as ser


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _plain(text: str) -> str:
    import re

    return re.sub(r"\x1b\[[0-9;]*m", "", text)


def _register_four_and_check_root(stack, state, capsys):
    """Register four members through cli.main with `--stack`, check `root`
    prints the root `register` did, and that the JAX package's tree over
    the same members gives it too."""
    base = ["--stack", stack, "--device", "cpu"]
    assert cli.main(base + ["root"]) == 1  # no members yet
    # four members: a power of two, so no padding leaf (whose hash depends
    # on the clock, as in the reference) enters the tree
    for i in (1, 2, 3, 4):
        assert cli.main(base + ["register", "--id", str(i), "--email", f"{i}@usc.edu"]) == 0
    out = _plain(capsys.readouterr().out).splitlines()
    assert out[-2] == "Number of Members: 4"
    root = int(out[-1].split(":")[1], 16)
    assert cli.main(base + ["root"]) == 0
    assert int(capsys.readouterr().out.strip(), 16) == root

    with open(state) as f:
        members = [JMember.from_json(json.dumps(m)) for m in json.load(f)]
    leaf, node = japp.get_config(stack).setup_params(jrng.test_rng())
    tree = japp.new_membership_tree(leaf, node, [m.hash(leaf) for m in members])
    assert tree.root() == root
    return root


def test_register_and_root(tmp_path, monkeypatch, capsys):
    state = tmp_path / "state.json"
    monkeypatch.setenv("ZKMEMBER_STATE", str(state))
    _register_four_and_check_root("pedersen381", state, capsys)


def test_unported_stack_is_refused(tmp_path, monkeypatch, capsys):
    """pedersen761 was refused (exit 2) before the BW6-761 stack was
    ported; it now registers, and `root` prints the JAX package's root of
    the same four members (48-byte Fr digests over the ed-on-bw6 curve)."""
    state = tmp_path / "state.json"
    monkeypatch.setenv("ZKMEMBER_STATE", str(state))
    root = _register_four_and_check_root("pedersen761", state, capsys)
    assert root.bit_length() > 256 and root < bw6.R


def test_verify_accepts_a_proof_and_rejects_a_wrong_leaf(capsys):
    root, leaf = 7 ** 40 % bls.R, 11 ** 50 % bls.R
    cs = ConstraintSystem(bls.Fr)
    r = g.FpVar.new_input(cs, root)
    lf = g.FpVar.new_input(cs, leaf)
    w = g.FpVar.new_witness(cs, 3)
    (w * w).enforce_equal(g.FpVar.new_witness(cs, 9), "square")
    (lf * w).enforce_equal(g.FpVar.new_witness(cs, leaf * 3 % bls.R), "leaf")
    (r * w).enforce_equal(g.FpVar.new_witness(cs, root * 3 % bls.R), "root")
    assert cs.is_satisfied()
    rng = frng.test_rng()
    pk, vk = groth16.setup(cs, "bls12_381", rng, host=True)
    proof = prove_lm.prove(prove_lm.Groth16KeysLM(pk, "cpu"), cs, rng=rng)
    args = ["--device", "cpu", "verify", "--root", hex(root), "--proof",
            ser.proof_to_bytes(proof).hex(), "--vk", ser.vk_to_bytes(vk).hex()]
    assert cli.main(args + ["--leaf", hex(leaf)]) == 0
    assert "Verification: True" in _plain(capsys.readouterr().out)
    assert cli.main(args + ["--leaf", hex(leaf + 1)]) == 1
    assert "Verification: False" in _plain(capsys.readouterr().out)
