"""A deep path's public inputs, re-derived: the root its member's digest
and siblings hash up to, and the digest, from the seed alone.

Member i's digest and then its ``depth`` siblings (leaf level first) are
uniform draws below the hash's field modulus from the seed's "path.<i>"
stream; the CRHs come from the "crh" stream (``pedersen_ref``).
"""

from __future__ import annotations

from reference import pedersen_ref as ped
from zkb.traffic import stream


def publics(config: dict, seed: int, members: list) -> dict:
    """{member index: [root, digest]} for the pool's members."""
    pd = config["pedersen"]
    leaf, node = ped.crh_pair(pd, stream(seed, "crh"))
    p = leaf.E.p
    out = {}
    for i in members:
        rng = stream(seed, f"path.{i}")
        digest = rng.randrange(p)
        sibs = [rng.randrange(p) for _ in range(config["depth"])]
        out[i] = [ped.path_root(leaf, node, digest, i, sibs, pd["digest_bytes"]), digest]
    return out
