"""Host-side generic elliptic-curve groups (short-Weierstrass + twisted Edwards).

Replaces the `ark-ec` group-law surface the reference consumes (SURVEY.md
section 2.2 row 2; use sites src/commitments/pedersen381/common.rs:13).
Host ops are used for parameter sampling, generators, serialization and the
O(1) verifier; bulk point arithmetic runs on TPU (zkmember_tpu_torch.curves.device).
"""

from __future__ import annotations


class SWCurve:
    """Short-Weierstrass curve  y^2 = x^3 + a x + b  over a host field class.

    Points are ``(x, y)`` tuples of field elements, or ``None`` for infinity.
    """

    def __init__(self, field, a, b, generator=None, order=None, cofactor=None, name="SW"):
        self.field = field
        self.a = a
        self.b = b
        self.generator = generator
        self.order = order  # prime order of the subgroup of interest
        self.cofactor = cofactor
        self.name = name

    def is_on_curve(self, P) -> bool:
        if P is None:
            return True
        x, y = P
        return y * y == x * x * x + self.a * x + self.b

    def neg(self, P):
        if P is None:
            return None
        x, y = P
        return (x, -y)

    def add(self, P, Q):
        if P is None:
            return Q
        if Q is None:
            return P
        x1, y1 = P
        x2, y2 = Q
        if x1 == x2:
            if (y1 + y2).is_zero():
                return None
            lam = (x1.square() * 3 + self.a) / y1.double()
        else:
            lam = (y2 - y1) / (x2 - x1)
        x3 = lam.square() - x1 - x2
        return (x3, lam * (x1 - x3) - y1)

    def double(self, P):
        return self.add(P, P)

    def mul(self, k: int, P):
        if P is None or k == 0:
            return None
        if k < 0:
            return self.mul(-k, self.neg(P))
        R = None
        while k:
            if k & 1:
                R = self.add(R, P)
            P = self.add(P, P)
            k >>= 1
        return R

    def lift_x(self, x, y_parity: int | None = None):
        """Return a point with the given x-coordinate, or None.

        When ``y_parity`` is given, select the root whose canonical integer
        value has that parity (point decompression).
        """
        rhs = x * x * x + self.a * x + self.b
        y = rhs.sqrt()
        if y is None:
            return None
        if y_parity is not None and hasattr(y, "v") and (y.v & 1) != y_parity:
            y = -y
        return (x, y)


class TECurve:
    """Twisted Edwards curve  a x^2 + y^2 = 1 + d x^2 y^2  (complete law).

    Identity is ``(0, 1)``. Requires ``a`` square and ``d`` non-square for the
    addition law to be complete, which holds for all instances shipped here.
    """

    def __init__(self, field, a, d, generator=None, order=None, cofactor=None, name="TE"):
        self.field = field
        self.a = a
        self.d = d
        self.generator = generator
        self.order = order
        self.cofactor = cofactor
        self.name = name

    def identity(self):
        return (self.field.zero(), self.field.one())

    def is_identity(self, P):
        return P[0].is_zero() and P[1] == self.field.one()

    def is_on_curve(self, P) -> bool:
        x, y = P
        x2, y2 = x.square(), y.square()
        return self.a * x2 + y2 == self.field.one() + self.d * x2 * y2

    def neg(self, P):
        x, y = P
        return (-x, y)

    def add(self, P, Q):
        x1, y1 = P
        x2, y2 = Q
        one = self.field.one()
        t = self.d * x1 * x2 * y1 * y2
        x3 = (x1 * y2 + y1 * x2) / (one + t)
        y3 = (y1 * y2 - self.a * x1 * x2) / (one - t)
        return (x3, y3)

    def double(self, P):
        return self.add(P, P)

    def mul(self, k: int, P):
        """k P by double-and-add in projective coordinates (X : Y : Z) over
        plain ints, one inversion at the end: the unified law
        (add-2008-bbjlp) is complete for a square a and a non-square d, and
        the affine result is the one the affine law gives."""
        if k == 0:
            return self.identity()
        if k < 0:
            return self.mul(-k, self.neg(P))
        p = self.field.p
        a, d = self.a.v, self.d.v

        def add(P1, P2):
            X1, Y1, Z1 = P1
            X2, Y2, Z2 = P2
            A = Z1 * Z2 % p
            B = A * A % p
            C = X1 * X2 % p
            D = Y1 * Y2 % p
            E = d * C % p * D % p
            F, G = (B - E) % p, (B + E) % p
            X3 = A * F % p * (((X1 + Y1) * (X2 + Y2) - C - D) % p) % p
            Y3 = A * G % p * ((D - a * C) % p) % p
            return X3, Y3, F * G % p

        R, Q = (0, 1, 1), (P[0].v, P[1].v, 1)
        while k:
            if k & 1:
                R = add(R, Q)
            Q = add(Q, Q)
            k >>= 1
        zi = pow(R[2], -1, p)
        return (self.field(R[0] * zi % p), self.field(R[1] * zi % p))

    def lift_y(self, y, x_sign: int | None = None):
        """Point with given y-coordinate (a x^2 = (1 - y^2)/(... )), or None."""
        one = self.field.one()
        num = y.square() - one
        den = self.d * y.square() - self.a
        x2 = num / den
        x = x2.sqrt()
        if x is None:
            return None
        if x_sign is not None and hasattr(x, "v") and (x.v & 1) != x_sign:
            x = -x
        return (x, y)
