"""Plain Groth16 reference: what every proof and the proving key must be.

Python integers only; imports nothing of the program and no array library.
The benchmark draws the toxic waste (alpha, beta, gamma, delta, tau) and
every proof's (r, s) itself, so the reference knows the discrete log of
every point the program makes and needs no pairing:

  QAP at tau   the ark/libsnark reduction: a domain of M = 2^k points
               (k the least with M >= constraints + instance variables),
               omega = g^((r - 1) / M) for the field's two-adic generator
               g, L_j(tau) = Z(tau) / M * omega^j / (tau - omega^j), and an
               extra term L_{nc + i} in u_i of each instance variable i.
  a proof      a = alpha + sum z_i u_i + r delta,  b = beta + sum z_i v_i
               + s delta,  c = (sum_{i >= ni} z_i (beta u_i + alpha v_i +
               w_i) + A(tau) B(tau) - C(tau)) / delta + s a + r b - r s
               delta, where A(tau) B(tau) - C(tau) = h(tau) Z(tau) for a
               witness that satisfies every row; A = a G1, B = b G2,
               C = c G1.
  the key      a_query[k] = u_{a_nonzero[k]} G1, b queries v_i in G1 and
               G2, h_query[k] = tau^k Z(tau) / delta G1, l_query[k] =
               (beta u + alpha v + w)_{ni + l_nonzero[k]} / delta G1, and
               the verifying key.

Scalar multiples of the fixed generators come from 4-bit window tables
(one mixed Jacobian addition a window).  A witness is a list of ints z
(z[0] = 1) and the rows of A, B and C as {variable: coefficient} dicts.
A curve's constants are ``curves/<curve>.json``, found by its name.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from functools import lru_cache

WINDOW = 4

CURVES_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "curves")


def _ints(v):
    """JSON numbers, hex strings and nested lists of them -> ints and tuples."""
    if isinstance(v, list):
        return tuple(_ints(x) for x in v)
    return int(v, 0) if isinstance(v, str) else v


@lru_cache(maxsize=None)
def curve_constants(name: str) -> dict:
    """``curves/<name>.json``: the base field q (G1's coordinates; G2's too,
    over Fq2 = Fq[u] / (u^2 + 1) where ``g2_fp2``), the scalar field r with
    its two-adic generator, y^2 = x^3 + b of both groups and their
    generators."""
    with open(os.path.join(CURVES_DIR, name + ".json")) as f:
        c = json.load(f)
    return {k: _ints(v) if k in ("q", "r", "b1", "b2", "g1", "g2") else v for k, v in c.items()}


class Fp:
    """Arithmetic mod q on ints."""

    def __init__(self, q: int):
        self.q = q
        self.zero, self.one = 0, 1

    def add(self, a, b):
        return (a + b) % self.q

    def sub(self, a, b):
        return (a - b) % self.q

    def mul(self, a, b):
        return a * b % self.q

    def small(self, a, k: int):
        return a * k % self.q

    def inv(self, a):
        return pow(a, -1, self.q)

    def is_zero(self, a) -> bool:
        return a == 0


class Fp2:
    """Arithmetic in Fq[u] / (u^2 + 1) on (c0, c1) pairs of ints."""

    def __init__(self, q: int):
        self.q = q
        self.zero, self.one = (0, 0), (1, 0)

    def add(self, a, b):
        q = self.q
        return ((a[0] + b[0]) % q, (a[1] + b[1]) % q)

    def sub(self, a, b):
        q = self.q
        return ((a[0] - b[0]) % q, (a[1] - b[1]) % q)

    def mul(self, a, b):
        q = self.q
        t0, t1 = a[0] * b[0], a[1] * b[1]
        return ((t0 - t1) % q, ((a[0] + a[1]) * (b[0] + b[1]) - t0 - t1) % q)

    def small(self, a, k: int):
        return (a[0] * k % self.q, a[1] * k % self.q)

    def inv(self, a):
        q = self.q
        d = pow((a[0] * a[0] + a[1] * a[1]) % q, -1, q)
        return (a[0] * d % q, -a[1] * d % q)

    def is_zero(self, a) -> bool:
        return a == (0, 0)


class Group:
    """y^2 = x^3 + b over F: affine points (x, y) or None for the identity,
    Jacobian (X, Y, Z) inside the sums."""

    def __init__(self, F, b, gen):
        self.F, self.b, self.gen = F, b, gen
        self._table = None

    def on_curve(self, P) -> bool:
        if P is None:
            return True
        F = self.F
        x, y = P
        return F.sub(F.mul(y, y), F.add(F.mul(F.mul(x, x), x), self.b)) == F.zero

    def double(self, P):
        if P is None:
            return None
        F = self.F
        X, Y, Z = P
        if F.is_zero(Y):
            return None
        A = F.mul(X, X)
        B = F.mul(Y, Y)
        C = F.mul(B, B)
        t = F.add(X, B)
        D = F.small(F.sub(F.sub(F.mul(t, t), A), C), 2)
        E = F.small(A, 3)
        X3 = F.sub(F.mul(E, E), F.small(D, 2))
        Y3 = F.sub(F.mul(E, F.sub(D, X3)), F.small(C, 8))
        return X3, Y3, F.small(F.mul(Y, Z), 2)

    def add_affine(self, P, Q):
        """Jacobian P + affine Q (either may be the identity)."""
        if Q is None:
            return P
        F = self.F
        if P is None:
            return Q[0], Q[1], F.one
        X1, Y1, Z1 = P
        x2, y2 = Q
        Z1Z1 = F.mul(Z1, Z1)
        U2 = F.mul(x2, Z1Z1)
        S2 = F.mul(F.mul(y2, Z1), Z1Z1)
        H = F.sub(U2, X1)
        rr = F.small(F.sub(S2, Y1), 2)
        if F.is_zero(H):
            return self.double(P) if F.is_zero(rr) else None
        HH = F.mul(H, H)
        I = F.small(HH, 4)  # noqa: E741
        J = F.mul(H, I)
        V = F.mul(X1, I)
        X3 = F.sub(F.sub(F.mul(rr, rr), J), F.small(V, 2))
        Y3 = F.sub(F.mul(rr, F.sub(V, X3)), F.small(F.mul(Y1, J), 2))
        t = F.add(Z1, H)
        Z3 = F.sub(F.sub(F.mul(t, t), Z1Z1), HH)
        return X3, Y3, Z3

    def affine(self, P):
        if P is None:
            return None
        F = self.F
        zi = F.inv(P[2])
        zi2 = F.mul(zi, zi)
        return F.mul(P[0], zi2), F.mul(F.mul(P[1], zi2), zi)

    def mul(self, k: int, P):
        """k P for an affine P by double-and-add (any k >= 0)."""
        acc = None
        for bit in bin(k)[2:] if k else "":
            acc = self.double(acc)
            if bit == "1":
                acc = self.add_affine(acc, P)
        return self.affine(acc)

    def table(self, nbits: int):
        """table[w][d] = d 16^w G, affine, d = 1..15 (index 0 unused)."""
        if self._table is None:
            rows = []
            base = self.gen
            for _ in range((nbits + WINDOW - 1) // WINDOW):
                row, acc = [None], None
                for _ in range(1, 1 << WINDOW):
                    acc = self.add_affine(acc, base)
                    row.append(self.affine(acc))
                rows.append(row)
                base = self.affine(self.add_affine((row[-1][0], row[-1][1], self.F.one), base))
            self._table = rows
        return self._table

    def gen_mul(self, k: int, nbits: int):
        """k G for 0 <= k < 2^nbits from the window table."""
        acc = None
        for w, row in enumerate(self.table(nbits)):
            d = (k >> (WINDOW * w)) & ((1 << WINDOW) - 1)
            if d:
                acc = self.add_affine(acc, row[d])
        return self.affine(acc)


def batch_inverse(vals: list, p: int) -> list:
    """Montgomery's trick: one inversion and 3 n products."""
    prefix = [1] * (len(vals) + 1)
    for i, v in enumerate(vals):
        prefix[i + 1] = prefix[i] * v % p
    inv = pow(prefix[-1], -1, p)
    out = [0] * len(vals)
    for i in range(len(vals) - 1, -1, -1):
        out[i] = prefix[i] * inv % p
        inv = inv * vals[i] % p
    return out


def from_mont_limbs(rows, q: int, n: int) -> list:
    """Rows of n little-endian 16-bit limbs in Montgomery form (R = 2^(16 n))
    -> canonical ints mod q."""
    rinv = pow(1 << (16 * n), -1, q)
    return [sum(int(v) << (16 * j) for j, v in enumerate(row)) * rinv % q for row in rows]


@dataclass
class Toxic:
    alpha: int
    beta: int
    gamma: int
    delta: int
    tau: int


class Reference:
    """One curve, one circuit's matrices, one toxic waste."""

    def __init__(self, curve: str, toxic: Toxic, A, B, C, num_instance: int, num_variables: int):
        c = curve_constants(curve)
        self.curve, self.c = curve, c
        r = self.r = c["r"]
        self.nbits = r.bit_length()
        self.G1 = Group(Fp(c["q"]), c["b1"], c["g1"])
        self.G2 = Group(Fp2(c["q"]) if c["g2_fp2"] else Fp(c["q"]), c["b2"], c["g2"])
        self.t = toxic
        self.A, self.B, self.C = A, B, C
        self.nc, self.ni, self.nv = len(A), num_instance, num_variables
        M = 1
        while M < self.nc + self.ni:
            M *= 2
        self.M = M
        tau = toxic.tau
        omega = pow(c["fr_gen"], (r - 1) >> c["two_adicity"], r)
        omega = pow(omega, (1 << c["two_adicity"]) // M, r)
        self.omega = omega
        self.z_tau = (pow(tau, M, r) - 1) % r
        wj = [1] * M
        for j in range(1, M):
            wj[j] = wj[j - 1] * omega % r
        den = batch_inverse([(tau - w) % r for w in wj], r)
        zm = self.z_tau * pow(M, -1, r) % r
        L = [zm * wj[j] % r * den[j] % r for j in range(M)]
        u, v, w = [0] * self.nv, [0] * self.nv, [0] * self.nv
        for j in range(self.nc):
            lj = L[j]
            for i, k in A[j].items():
                u[i] += k * lj
            for i, k in B[j].items():
                v[i] += k * lj
            for i, k in C[j].items():
                w[i] += k * lj
        for i in range(self.ni):
            u[i] += L[self.nc + i]
        self.u = [x % r for x in u]
        self.v = [x % r for x in v]
        self.w = [x % r for x in w]
        al, be = toxic.alpha, toxic.beta
        self.abc = [(be * self.u[i] + al * self.v[i] + self.w[i]) % r for i in range(self.nv)]
        self.delta_inv = pow(toxic.delta, -1, r)

    # -- the generators themselves --------------------------------------------

    def generators_ok(self) -> bool:
        """Both generators lie on their curves and have order r."""
        return all(G.on_curve(G.gen) and G.gen is not None and G.mul(self.r, G.gen) is None
                   for G in (self.G1, self.G2))

    # -- witnesses -------------------------------------------------------------

    def unsatisfied_rows(self, z: list) -> int:
        """Rows of A z * B z = C z that do not hold (the instance rows hold
        by construction: A = z_i, B = C = 0 is not a constraint on z)."""
        r = self.r

        def dot(row):
            return sum(k * z[i] for i, k in row.items()) % r

        return sum(1 for a, b, c in zip(self.A, self.B, self.C) if dot(a) * dot(b) % r != dot(c))

    def witness_scalars(self, z: list) -> tuple:
        """(A(tau), B(tau), the part of c before r and s) of one witness."""
        r = self.r
        az = sum(zi * ui for zi, ui in zip(z, self.u)) % r
        bz = sum(zi * vi for zi, vi in zip(z, self.v)) % r
        cz = sum(zi * wi for zi, wi in zip(z, self.w)) % r
        priv = sum(z[i] * self.abc[i] for i in range(self.ni, self.nv)) % r
        return az, bz, (priv + az * bz - cz) * self.delta_inv % r

    def proof_scalars(self, ws: tuple, rr: int, ss: int) -> tuple:
        """(a, b, c) of the proof of a witness with scalars ws under (r, s)."""
        r, t = self.r, self.t
        az, bz, c0 = ws
        a = (t.alpha + az + rr * t.delta) % r
        b = (t.beta + bz + ss * t.delta) % r
        c = (c0 + ss * a + rr * b - rr * ss * t.delta) % r
        return a, b, c

    def proof_points(self, a: int, b: int, c: int) -> tuple:
        """(A, B, C) affine."""
        n = self.nbits
        return self.G1.gen_mul(a, n), self.G2.gen_mul(b, n), self.G1.gen_mul(c, n)

    # -- the key ----------------------------------------------------------------

    def nonzero(self) -> dict:
        """The columns each query keeps (variables with a nonzero scalar; l's
        relative to the first witness variable)."""
        return {
            "a": [i for i in range(self.nv) if self.u[i]],
            "b": [i for i in range(self.nv) if self.v[i]],
            "l": [i - self.ni for i in range(self.ni, self.nv) if self.abc[i] * self.delta_inv % self.r],
        }

    def query_scalar(self, query: str, k: int, nz: dict) -> int:
        r, t = self.r, self.t
        if query == "a":
            return self.u[nz["a"][k]]
        if query in ("b_g1", "b_g2"):
            return self.v[nz["b"][k]]
        if query == "h":
            return pow(t.tau, k, r) * self.z_tau % r * self.delta_inv % r
        if query == "l":
            return self.abc[self.ni + nz["l"][k]] * self.delta_inv % r
        raise ValueError(query)

    def key_point(self, query: str, k: int, nz: dict):
        G = self.G2 if query == "b_g2" else self.G1
        return G.gen_mul(self.query_scalar(query, k, nz), self.nbits)

    def vk_points(self) -> dict:
        t, n, r = self.t, self.nbits, self.r
        gamma_inv = pow(t.gamma, -1, r)
        return {
            "alpha_g1": self.G1.gen_mul(t.alpha, n),
            "beta_g1": self.G1.gen_mul(t.beta, n),
            "delta_g1": self.G1.gen_mul(t.delta, n),
            "beta_g2": self.G2.gen_mul(t.beta, n),
            "gamma_g2": self.G2.gen_mul(t.gamma, n),
            "delta_g2": self.G2.gen_mul(t.delta, n),
            "gamma_abc_g1": [self.G1.gen_mul(self.abc[i] * gamma_inv % r, n) for i in range(self.ni)],
        }


def truncate(x: int, limbs: int) -> int:
    """x held in `limbs` 16-bit limbs: the bits above are lost."""
    return x & ((1 << (16 * limbs)) - 1)
