"""Membership circuits of a deep Pedersen Merkle tree that is not held.

The circuit only consumes an authentication path, so a random path of the
configuration's ``depth`` and the root it hashes up to (on the host) are a
valid witness of the exact circuit a registrar of 2^depth members would
give.  Only the paths and their roots are held, not the tree.  The path
generator is a frozen copy of the program's ``app.scale.synthetic_path``,
with the leaf's index given (the member) and its draws from the seed's
stream of that member.  Each path hashes to its own root.
"""

from __future__ import annotations

from zkb.spec import Registrar
from zkb.traffic import stream


def synthetic_path(cfg, leaf_params, node_params, depth: int, rng, index: int):
    """(root, leaf_digest, MerklePath) of a random depth-`depth` branch to leaf
    `index`: the member's digest and the siblings drawn from `rng`."""
    from zkmember_tpu_torch.hash import pedersen as ph
    from zkmember_tpu_torch.merkle.tree import MerklePath

    p = cfg.scalar_field.p
    spec_bytes = node_params.spec.n * 2
    leaf_digest = rng.randrange(p)  # the app-level member digest (public)
    # tree-level leaf hash of the app-level digest (as MerkleTree hashes it)
    cur = ph.hash_bytes_host(leaf_params, int(leaf_digest).to_bytes(spec_bytes, "little")).v
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


def build(config: dict, seed: int, device) -> Registrar:
    from zkmember_tpu_torch.app import circuits as app

    if config["tree_held"] != "paths only":
        raise ValueError(f"deep_path holds paths only, not {config['tree_held']!r}")
    stack = app.get_config(config["stack"])
    leaf, node = stack.setup_params(stream(seed, "crh"))
    depth = config["depth"]
    paths: dict = {}

    def path(i: int):
        if i not in paths:
            paths[i] = synthetic_path(stack, leaf, node, depth, stream(seed, f"path.{i}"), i)
        return paths[i]

    def synthesize(i: int):
        root, digest, auth = path(i)
        return app.MerkleTreeCircuit(config=stack, leaf_params=leaf, node_params=node, root=root,
                                     leaf_hash=digest,
                                     authentication_path=auth).generate_constraints()

    return Registrar(config["curve"], 1 << depth, synthesize)
