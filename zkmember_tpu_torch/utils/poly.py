"""Host polynomial helpers over Z_p (counterpart of zkmember_tpu.utils.poly).

Coefficient lists, low -> high.  Used by Marlin's AHP for O(N) coefficient
bookkeeping; the O(N log N) transforms of membership-size polynomials go
through the device NTT (``snark.marlin.PolyEngine``), with this host
radix-2 NTT as the small-size path.  Every function returns what the
reference's does; ``trim`` is linear where the reference's is quadratic.
"""

from __future__ import annotations


def host_ntt(vals: list[int], w: int, p: int) -> list[int]:
    """In-place-style iterative radix-2 NTT; w = primitive len(vals)-th root."""
    n = len(vals)
    assert n & (n - 1) == 0
    a = list(vals)
    # bit reversal
    j = 0
    for i in range(1, n):
        bit = n >> 1
        while j & bit:
            j ^= bit
            bit >>= 1
        j |= bit
        if i < j:
            a[i], a[j] = a[j], a[i]
    m = 1
    while m < n:
        wm = pow(w, n // (2 * m), p)
        for k in range(0, n, 2 * m):
            x = 1
            for l in range(m):
                t = a[k + l + m] * x % p
                a[k + l + m] = (a[k + l] - t) % p
                a[k + l] = (a[k + l] + t) % p
                x = x * wm % p
        m *= 2
    return a


def host_intt(vals: list[int], w: int, p: int) -> list[int]:
    n = len(vals)
    ninv = pow(n, -1, p)
    out = host_ntt(vals, pow(w, -1, p), p)
    return [v * ninv % p for v in out]


def poly_add(a: list[int], b: list[int], p: int) -> list[int]:
    n = max(len(a), len(b))
    return [((a[i] if i < len(a) else 0) + (b[i] if i < len(b) else 0)) % p for i in range(n)]


def poly_scale(a: list[int], c: int, p: int) -> list[int]:
    return [x * c % p for x in a]


def poly_eval(a: list[int], z: int, p: int) -> int:
    acc = 0
    for c in reversed(a):
        acc = (acc * z + c) % p
    return acc


def trim(a: list[int]) -> list[int]:
    """a without its trailing zeros, in one slice (the reference drops them
    one slice at a time: quadratic, 91 s for an h_2 of 2^18 coefficients)."""
    end = len(a)
    while end and a[end - 1] == 0:
        end -= 1
    return a[:end]


def divide_by_vanishing(f: list[int], n: int, p: int) -> tuple[list[int], list[int]]:
    """(quotient, remainder) of f / (X^n - 1); exact O(deg f)."""
    f = list(f)
    d = len(f) - 1
    if d < n:
        return [], f
    q = [0] * (d - n + 1)
    for k in range(d, n - 1, -1):
        q[k - n] = f[k] % p
        f[k - n] = (f[k - n] + f[k]) % p  # remainder folds down
        f[k] = 0
    return q, trim(f[:n])


def batch_inverse(vals: list[int], p: int) -> list[int]:
    """Montgomery's trick; zero entries map to zero."""
    n = len(vals)
    prefix = [1] * (n + 1)
    for i, v in enumerate(vals):
        prefix[i + 1] = prefix[i] * (v if v else 1) % p
    inv = pow(prefix[n], -1, p)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = prefix[i] * inv % p if vals[i] else 0
        inv = inv * (vals[i] if vals[i] else 1) % p
    return out


def lagrange_interpolate(xs: list[int], ys: list[int], p: int) -> list[int]:
    """Dense O(k^2) interpolation (used only for the tiny input domain X)."""
    k = len(xs)
    poly = [0] * k
    for i in range(k):
        # numerator prod_{j != i} (X - x_j)
        num = [1]
        for j in range(k):
            if j != i:
                num = [
                    ((num[l - 1] if l > 0 else 0) - xs[j] * (num[l] if l < len(num) else 0)) % p
                    for l in range(len(num) + 1)
                ]
        denom = 1
        for j in range(k):
            if j != i:
                denom = denom * (xs[i] - xs[j]) % p
        c = ys[i] * pow(denom, -1, p) % p
        for l in range(len(num)):
            poly[l] = (poly[l] + c * num[l]) % p
    return poly
