"""A registrar's membership circuits, built through the program's app layer.

The registrar of ``members`` members: the reference's mock members (ids
1..n, emails ``<i>@usc.edu``; a frozen copy of the program's
``app.member.generate_members``) with join dates drawn from the seed, in
the configuration's ``join_dates`` span, where the reference stamps the
clock, their digests hashed by
``Member.hash_batch`` on the device, and the tree by
``new_membership_tree`` (on the device above 64 leaves).  The Pedersen CRH
parameters come from the seed too.  ``synthesize(i)`` makes member i's
circuit from its authentication path.
"""

from __future__ import annotations

from datetime import datetime, timezone

from zkb.spec import Registrar
from zkb.traffic import stream

def generate_members(amount: int, seed: int, join_dates: dict) -> list:
    """Mock registrar: ids "1".."{n}", emails "{i}@usc.edu", join dates from
    the seed's "join_dates" stream, ``span_s`` seconds from ``from``."""
    from zkmember_tpu_torch.app.member import Member

    dates = stream(seed, "join_dates")
    return [Member(id=str(i), email=f"{i}@usc.edu",
                   join_date=datetime.fromtimestamp(
                       join_dates["from"] + dates.randrange(join_dates["span_s"]), timezone.utc))
            for i in range(1, amount + 1)]


def build(config: dict, seed: int, device) -> Registrar:
    from zkmember_tpu_torch.app import circuits as app
    from zkmember_tpu_torch.app.member import Member

    stack = app.get_config(config["stack"])
    leaf, node = stack.setup_params(stream(seed, "crh"))
    members = generate_members(config["members"], seed, config["join_dates"])
    digests = Member.hash_batch(leaf, members, device=device)
    tree = app.new_membership_tree(leaf, node, digests, device)
    root = tree.root()

    def synthesize(i: int):
        return app.MerkleTreeCircuit(config=stack, leaf_params=leaf, node_params=node, root=root,
                                     leaf_hash=digests[i],
                                     authentication_path=tree.generate_proof(i)).generate_constraints()

    return Registrar(config["curve"], config["members"], synthesize)
