"""Membership circuits + per-curve-stack configurations (pedersen381/761).

The framework analog of the reference's `src/commitments/` layer:
  * `Pedersen381Config` — Jubjub Pedersen hashes over BLS12-381 Fr, windows
    4x128 (two-to-one) and 4x144 (leaf)
    (src/commitments/pedersen381/common.rs:17-57)
  * `Pedersen761Config` — ed-on-bw6 Pedersen hashes over BW6-761 Fr, windows
    4x192 for both (src/commitments/pedersen761/common.rs:17-47)
  * `MerkleTreeCircuit` — constants: both CRH parameter tables; public
    inputs: root, leaf digest; private witness: the authentication path
    (src/commitments/pedersen381/constraint.rs:24-72)
  * `new_membership_tree` / `clean_membership_list` — pad the member list to
    the next power of two with hashed default members, including the
    `num_members == 1 -> pad 1` special case (common.rs:89-110).

Unlike the reference, the configuration is a runtime object, not a compile
-time Cargo feature (SURVEY.md section 5.6).
"""

from __future__ import annotations

from dataclasses import dataclass

from zkmember_tpu_torch.fields.host import prime_field
from zkmember_tpu_torch.hash import pedersen as ph
from zkmember_tpu_torch.merkle.tree import MerkleTree, MerklePath
from zkmember_tpu_torch.r1cs.cs import ConstraintSystem
from zkmember_tpu_torch.r1cs import gadgets as g
from zkmember_tpu_torch.app.member import Member
from zkmember_tpu_torch.utils import rng as frng


class StackConfig:
    """One curve stack: embedded TE curve + window shapes + pairing curve."""

    def __init__(self, name, te_curve, scalar_field, leaf_window, node_window):
        self.name = name
        self.te_curve = te_curve
        self.scalar_field = scalar_field  # host field class (= TE base field)
        self.leaf_window = leaf_window
        self.node_window = node_window

    def setup_params(self, rng) -> tuple[ph.PedersenParams, ph.PedersenParams]:
        """Sample (leaf, two-to-one) CRH parameters, leaf first — matching
        the reference's sampling order (pedersen381/mod.rs:24-25)."""
        leaf = ph.PedersenParams(self.te_curve, self.leaf_window, rng)
        node = ph.PedersenParams(self.te_curve, self.node_window, rng)
        return leaf, node


def _config_381() -> StackConfig:
    from zkmember_tpu_torch.curves import jubjub, bls12_381

    return StackConfig(
        "pedersen381",
        jubjub.CURVE,
        bls12_381.Fr,
        ph.LEAF_WINDOW_381,
        ph.TWO_TO_ONE_WINDOW_381,
    )


def _config_761() -> StackConfig:
    from zkmember_tpu_torch.curves import bw6_761, ed377

    return StackConfig(
        "pedersen761",
        ed377.CURVE,
        bw6_761.Fr,
        ph.WINDOW_761,
        ph.WINDOW_761,
    )


_CONFIGS = {}
_BUILDERS = {"pedersen381": _config_381, "pedersen761": _config_761}


def get_config(name: str) -> StackConfig:
    if name not in _BUILDERS:
        raise ValueError(f"unsupported stack config {name!r} (pedersen381 or pedersen761)")
    if name not in _CONFIGS:
        _CONFIGS[name] = _BUILDERS[name]()
    return _CONFIGS[name]


# ---------------------------------------------------------------------------
# membership store (L5 of SURVEY.md section 1)
# ---------------------------------------------------------------------------


def clean_membership_list(leaf_params: ph.PedersenParams, leaves: list[int]) -> list[int]:
    """Pad leaf digests to the next power of two with default-member hashes.

    Mirrors common.rs:89-110, including the single-member special case.
    """
    n = len(leaves)
    num_needed = 1 if n == 1 else ((1 << (n - 1).bit_length()) - n if n & (n - 1) else 0)
    pad_digest = Member.default().hash(leaf_params)
    return leaves + [pad_digest] * num_needed


def new_membership_tree(
    leaf_params: ph.PedersenParams,
    node_params: ph.PedersenParams,
    leaf_digests: list[int],
    device=None,
) -> MerkleTree:
    """Build the membership tree from member digests (common.rs:80-87).

    App-level leaves are the member digests; the tree hashes their byte
    encodings again with LeafHash, exactly like the reference's MerkleTree.
    The tree's "auto" backend hashes above 64 leaves on `device` (the card
    unless the caller passes "cpu").
    """
    digests = clean_membership_list(leaf_params, leaf_digests)
    nbytes = node_params.spec.n * 2  # digest byte width = limb width
    leaf_bytes = [int(d).to_bytes(nbytes, "little") for d in digests]
    return MerkleTree(leaf_params, node_params, leaf_bytes, device=device)


# ---------------------------------------------------------------------------
# the circuit (L6)
# ---------------------------------------------------------------------------


@dataclass
class MerkleTreeCircuit:
    """Membership circuit: public (root, leaf digest), private (path)."""

    config: StackConfig
    leaf_params: ph.PedersenParams
    node_params: ph.PedersenParams
    root: int
    leaf_hash: int
    authentication_path: MerklePath | None  # None -> synthesize structure only

    def generate_constraints(self, cs: ConstraintSystem | None = None) -> ConstraintSystem:
        """Trace the circuit; returns the populated constraint system.

        Structure matches constraint.rs:38-72: params as constants, root and
        leaf as public inputs, path as witness, verify_membership, enforce
        the is-member boolean.
        """
        if cs is None:
            cs = ConstraintSystem(self.config.scalar_field)
        path = self.authentication_path
        if path is None:
            raise ValueError("AssignmentMissing: authentication_path")

        root = g.FpVar.new_input(cs, self.root)
        leaf = g.FpVar.new_input(cs, self.leaf_hash)

        depth = len(path.siblings)
        index_bits = [
            g.Boolean.new_witness(cs, (path.leaf_index >> i) & 1) for i in range(depth)
        ]
        sibling_vars = [g.FpVar.new_witness(cs, s) for s in path.siblings]

        is_member = g.merkle_path_gadget(
            cs, self.leaf_params, self.node_params, root, leaf, index_bits, sibling_vars
        )
        is_member.enforce_true()
        return cs
