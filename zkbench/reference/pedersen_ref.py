"""Plain Pedersen CRH over a twisted Edwards curve, and the Merkle path
hashes over it: what a registrar's public inputs (its root and a member's
digest) must be.

Python integers only; imports nothing of the program.  The curve is
``curves/<name>.json``: a x^2 + y^2 = 1 + d x^2 y^2 over F_p, the prime
order of its subgroup, its cofactor, and its generator (the cofactor times
the point of least y >= 2, x even).  A CRH of W windows of 4 bits holds W
generators g_w = k_w G, each k_w drawn in [1, order) from the run's stream
(a leaf CRH's first, then a node CRH's, from one stream); it maps a message
of at most W / 2 bytes, read as a little-endian integer m, to the affine x
of sum_w ((m >> 4 w) & 15) g_w.  A node hashes its children's digests
(``digest_bytes`` each, little-endian) concatenated, left first; a tree's
leaf is the leaf CRH of its member digest's bytes.
"""

from __future__ import annotations

import json
import os
from functools import lru_cache

from reference.groth16_ref import CURVES_DIR, _ints

WINDOW_BITS = 4


def sqrt(a: int, p: int) -> int | None:
    """A square root of a mod the odd prime p (Tonelli-Shanks), or None."""
    a %= p
    if a == 0:
        return 0
    if pow(a, (p - 1) // 2, p) != 1:
        return None
    q, s = p - 1, 0
    while q % 2 == 0:
        q, s = q // 2, s + 1
    z = 2
    while pow(z, (p - 1) // 2, p) != p - 1:
        z += 1
    m, c, t, x = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
    while t != 1:
        i, t2 = 0, t
        while t2 != 1:
            t2, i = t2 * t2 % p, i + 1
        b = pow(c, 1 << (m - i - 1), p)
        m, c, t, x = i, b * b % p, t * b * b % p, x * b % p
    return x


class Edwards:
    """a x^2 + y^2 = 1 + d x^2 y^2 over F_p: affine (x, y), extended
    (X, Y, Z, T) with x = X / Z, y = Y / Z, T = X Y / Z inside the sums."""

    IDENTITY = (0, 1, 1, 0)

    def __init__(self, c: dict):
        p = self.p = _ints(c["p"])
        self.a = _ints(c["a"]) % p
        num, den = (_ints(v) for v in c["d"])
        self.d = num * pow(den, -1, p) % p
        self.order, self.cofactor = _ints(c["order"]), c["cofactor"]
        self.gen = self._generator()

    def ext(self, P):
        return P[0], P[1], 1, P[0] * P[1] % self.p

    def affine(self, E):
        p = self.p
        zi = pow(E[2], -1, p)
        return E[0] * zi % p, E[1] * zi % p

    def add(self, E1, E2):
        """Unified extended addition (Hisil-Wong-Carter-Dawson 2008)."""
        p = self.p
        X1, Y1, Z1, T1 = E1
        X2, Y2, Z2, T2 = E2
        A, B = X1 * X2 % p, Y1 * Y2 % p
        C, D = self.d * T1 % p * T2 % p, Z1 * Z2 % p
        E = ((X1 + Y1) * (X2 + Y2) - A - B) % p
        F, G, H = (D - C) % p, (D + C) % p, (B - self.a * A) % p
        return E * F % p, G * H % p, F * G % p, E * H % p

    def mul(self, k: int, E):
        acc = self.IDENTITY
        for bit in bin(k)[2:] if k else "":
            acc = self.add(acc, acc)
            if bit == "1":
                acc = self.add(acc, E)
        return acc

    def on_curve(self, P) -> bool:
        p, (x, y) = self.p, P
        x2, y2 = x * x % p, y * y % p
        return (self.a * x2 + y2 - 1 - self.d * x2 % p * y2) % p == 0

    def _generator(self):
        p, y = self.p, 2
        while True:
            x = sqrt((y * y - 1) * pow((self.d * y * y - self.a) % p, -1, p), p)
            if x is not None:
                g = self.affine(self.mul(self.cofactor, self.ext((x if x % 2 == 0 else p - x, y))))
                if g != (0, 1):
                    return g
            y += 1


@lru_cache(maxsize=None)
def edwards(name: str) -> Edwards:
    with open(os.path.join(CURVES_DIR, name + ".json")) as f:
        return Edwards(json.load(f))


class CRH:
    """One Pedersen CRH of `windows` 4-bit windows; its generators drawn
    from `rng` now, their multiples made when a message first needs them."""

    def __init__(self, curve: Edwards, windows: int, rng):
        self.E, self.windows = curve, windows
        self.ks = [rng.randrange(1, curve.order) for _ in range(windows)]
        self._rows: dict = {}

    def _row(self, w: int) -> list:
        """[d g_w for d in 0..15], extended."""
        if w not in self._rows:
            E = self.E
            g = E.mul(self.ks[w], E.ext(E.gen))
            row = [E.IDENTITY]
            for _ in range(1, 1 << WINDOW_BITS):
                row.append(E.add(row[-1], g))
            self._rows[w] = row
        return self._rows[w]

    def hash(self, data: bytes) -> int:
        if 8 * len(data) > WINDOW_BITS * self.windows:
            raise ValueError(f"{len(data)} bytes exceed {self.windows} windows")
        m = int.from_bytes(data, "little")
        acc, w = self.E.IDENTITY, 0
        while m:
            d = m & ((1 << WINDOW_BITS) - 1)
            if d:
                acc = self.E.add(acc, self._row(w)[d])
            m >>= WINDOW_BITS
            w += 1
        return self.E.affine(acc)[0]


def crh_pair(pedersen: dict, rng) -> tuple[CRH, CRH]:
    """(leaf, node) CRHs of a configuration's ``pedersen`` entry, the leaf's
    generators drawn first."""
    E = edwards(pedersen["curve"])
    return CRH(E, pedersen["leaf_windows"], rng), CRH(E, pedersen["node_windows"], rng)


def node_hash(node: CRH, left: int, right: int, nbytes: int) -> int:
    return node.hash(left.to_bytes(nbytes, "little") + right.to_bytes(nbytes, "little"))


def path_root(leaf: CRH, node: CRH, digest: int, index: int, siblings: list, nbytes: int) -> int:
    """The root that member `index`'s digest and its siblings (leaf level
    first) hash up to."""
    cur = leaf.hash(digest.to_bytes(nbytes, "little"))
    for lvl, sib in enumerate(siblings):
        cur = node_hash(node, sib, cur, nbytes) if (index >> lvl) & 1 else node_hash(node, cur, sib, nbytes)
    return cur


def tree_root(leaf: CRH, node: CRH, digests: list, nbytes: int) -> int:
    """The root of the tree over a power-of-two count of member digests."""
    if len(digests) < 2 or len(digests) & (len(digests) - 1):
        raise ValueError(f"{len(digests)} leaves: a power of two >= 2 is needed")
    level = [leaf.hash(d.to_bytes(nbytes, "little")) for d in digests]
    while len(level) > 1:
        level = [node_hash(node, level[i], level[i + 1], nbytes) for i in range(0, len(level), 2)]
    return level[0]
