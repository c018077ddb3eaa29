"""A registrar's public inputs, re-derived: its root and each member's
digest, from the seed alone.

The members are the configuration's mock registrar (ids 1..n, emails
``<i>@usc.edu``, join dates from the seed's "join_dates" stream in the
configuration's ``join_dates`` span); a member's bytes are its id, its
email, its join date as a big-endian signed 64-bit timestamp, then a zero
byte for no end date and one for no padding.  Its digest is the leaf CRH
of those bytes, and the tree hashes the digests again as its leaves
(``pedersen_ref``).  The CRHs are drawn from the seed's "crh" stream.
"""

from __future__ import annotations

from reference import pedersen_ref as ped
from zkb.traffic import stream


def member_bytes(i: int, joined: int) -> bytes:
    """Member i's (ids from 1) encoding, with no end date and no padding."""
    return (str(i).encode() + f"{i}@usc.edu".encode()
            + joined.to_bytes(8, "big", signed=True) + b"\x00" + b"\x00")


def publics(config: dict, seed: int, members: list) -> dict:
    """{member index: [root, digest]} for the pool's members (indices from 0)."""
    pd = config["pedersen"]
    leaf, node = ped.crh_pair(pd, stream(seed, "crh"))
    jd, dates = config["join_dates"], stream(seed, "join_dates")
    digests = [leaf.hash(member_bytes(i, jd["from"] + dates.randrange(jd["span_s"])))
               for i in range(1, config["members"] + 1)]
    root = ped.tree_root(leaf, node, digests, pd["digest_bytes"])
    return {i: [root, digests[i]] for i in members}
