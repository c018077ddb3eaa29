"""Binary Merkle tree over Pedersen digests, built level by level.

Counterpart of zkmember_tpu.merkle.tree (ark-crypto-primitives'
``MerkleTree``/``Path`` semantics):
  * tree leaves are byte strings; the tree FIRST hashes each leaf with
    LeafHash (so the membership trees, whose app-level leaves are already
    member digests, hash those digests again);
  * internal node = TwoToOneHash(bytes(left_digest) || bytes(right_digest));
  * ``MerklePath`` carries the sibling digests from the leaf level upward
    plus the leaf index; verify recomputes to the root.

The device backend hashes each level as ONE batched hash
(``hash.pedersen.hash_bits_tiled`` / ``two_to_one_tiled``: K3 on the card);
the host backend hashes node by node in Python bignums.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from zkmember_tpu_torch import device as devices
from zkmember_tpu_torch.fields import spec as fs
from zkmember_tpu_torch.hash import pedersen as ph

# "auto" hashes up to this many leaves on the host (the reference's rule:
# small trees are dispatch latency on a device)
HOST_MAX_LEAVES = 64


@dataclass
class MerklePath:
    """Authentication path: sibling digests bottom-up + the leaf index."""

    leaf_index: int
    siblings: list  # host ints, leaf level first
    leaf_digest: int  # the tree-level leaf hash (LeafHash(bytes(app leaf)))


class MerkleTree:
    """Binary Merkle tree with power-of-two leaf count.

    leaf_params / node_params: PedersenParams for LeafHash / TwoToOneHash.
    leaves: list of byte strings (the app passes member digest bytes).
    backend: "host", "device", or "auto" (the host up to HOST_MAX_LEAVES
    leaves, the device above: chosen by size, never on failure).  The
    device backend runs on ``device.resolve(device)``: the card unless the
    caller passes "cpu".  Levels are (width, n) uint32 canonical limbs
    either way.
    """

    def __init__(
        self,
        leaf_params: ph.PedersenParams,
        node_params: ph.PedersenParams,
        leaves,
        backend: str = "auto",
        device=None,
    ):
        if len(leaves) < 2 or len(leaves) & (len(leaves) - 1):
            raise ValueError(
                "leaf count must be a power of two >= 2 (pad first: see "
                "app.circuits.clean_membership_list)"
            )
        if backend not in ("auto", "host", "device"):
            raise ValueError(f"unknown backend {backend!r} (auto, host or device)")
        self.leaf_params = leaf_params
        self.node_params = node_params
        self.spec = node_params.spec
        if backend == "auto":
            backend = "host" if len(leaves) <= HOST_MAX_LEAVES else "device"
        if backend == "device":
            dev = devices.resolve(device)
            cap = leaf_params.window.capacity_bits
            bits = np.stack([ph.bytes_to_bits(b, cap) for b in leaves])
            self.levels = [ph.hash_bits_tiled(leaf_params, bits, dev)]
            while self.levels[-1].shape[0] > 1:
                cur = self.levels[-1]
                self.levels.append(ph.two_to_one_tiled(node_params, cur[0::2], cur[1::2], dev))
            return
        nbytes = self.spec.n * fs.LIMB_BITS // 8
        cur = [ph.hash_bytes_host(leaf_params, b).v for b in leaves]
        self.levels = [fs.ints_to_limbs(cur, self.spec.n)]
        while len(cur) > 1:
            cur = [
                ph.two_to_one_host(
                    node_params,
                    int(cur[i]).to_bytes(nbytes, "little"),
                    int(cur[i + 1]).to_bytes(nbytes, "little"),
                ).v
                for i in range(0, len(cur), 2)
            ]
            self.levels.append(fs.ints_to_limbs(cur, self.spec.n))

    @property
    def depth(self) -> int:
        return len(self.levels) - 1

    def root(self) -> int:
        return fs.limbs_to_ints(np.asarray(self.levels[-1]))[0]

    def leaf_digest(self, i: int) -> int:
        return fs.limbs_to_ints(np.asarray(self.levels[0][i : i + 1]))[0]

    def generate_proof(self, i: int) -> MerklePath:
        sibs = []
        idx = i
        for level in self.levels[:-1]:
            sibs.append(fs.limbs_to_ints(np.asarray(level[idx ^ 1 : (idx ^ 1) + 1]))[0])
            idx >>= 1
        return MerklePath(leaf_index=i, siblings=sibs, leaf_digest=self.leaf_digest(i))


def path_verify_host(
    leaf_params: ph.PedersenParams,
    node_params: ph.PedersenParams,
    root: int,
    leaf_bytes: bytes,
    path: MerklePath,
) -> bool:
    """Host path verification (the reference's Path::verify, SURVEY.md 3.4)."""
    spec = node_params.spec
    nbytes = spec.n * fs.LIMB_BITS // 8
    cur = ph.hash_bytes_host(leaf_params, leaf_bytes).v
    idx = path.leaf_index
    for sib in path.siblings:
        l, r = (sib, cur) if idx & 1 else (cur, sib)
        cur = ph.two_to_one_host(
            node_params,
            int(l).to_bytes(nbytes, "little"),
            int(r).to_bytes(nbytes, "little"),
        ).v
        idx >>= 1
    return cur == root
