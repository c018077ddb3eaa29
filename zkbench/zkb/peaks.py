"""The card's peaks and the MSM problem's work, frozen here so that a
change to the program cannot move the yardstick.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit): 3.35e12 B/s of HBM3, and 67e12 float32 FLOP/s outside the tensor
cores, which is 2 flops a fused multiply-add on 128 float32 lanes an SM;
the 32-bit integer multiply-add (IMAD) pipe has half those lanes, so
16.75e12 IMAD/s.  A 32 x 32 -> 64-bit product is two IMADs (low and high
word).

The MSM problem is counted from its sizes, not from the kernels that
solve it: a Straus MSM of 4-bit windows over the scalar field's bits, with
the [0..15] P tables given, reduces each window's selected points with
one complete addition a point (lanes - 1 a window) and joins the windows
with 4 (W - 1) doublings and W - 1 additions (Horner).  A complete a = 0
addition is 12 base-field products and a doubling 8 (an Fp2 product is
three base ones); a Montgomery product of n 16-bit limbs (N = n / 2 words)
is 4 N^2 + N IMADs.  Bytes: each point (affine), each scalar and each
result (projective) moved once, at 2 bytes a 16-bit limb.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 67e12 / 4
WINDOW_BITS = 4
ADD_PRODUCTS = 12
DOUBLE_PRODUCTS = 8


def mont_mul_imads(n_limbs: int) -> int:
    words = n_limbs // 2
    return 4 * words * words + words


def msm_imads(n_limbs: int, fp2: bool, nbits: int, lanes: int) -> int:
    """IMADs of one MSM row of `lanes` points over coordinates of n_limbs."""
    W = (nbits + WINDOW_BITS - 1) // WINDOW_BITS
    ext = 3 if fp2 else 1
    adds = W * (lanes - 1) + (W - 1)
    dbls = 4 * (W - 1)
    return (adds * ADD_PRODUCTS + dbls * DOUBLE_PRODUCTS) * ext * mont_mul_imads(n_limbs)


def msm_bytes(n_limbs: int, fp2: bool, fr_limbs: int, lanes: int) -> int:
    c = 2 if fp2 else 1
    return lanes * (2 * c * n_limbs * 2 + fr_limbs * 2) + 3 * c * n_limbs * 2


def least_seconds(rows) -> tuple[float, str, float, float]:
    """rows: (n_limbs, fp2, nbits, fr_limbs, lanes) of each MSM row of one
    proof.  Returns (least seconds, which bound binds, IMADs, bytes)."""
    imads = sum(msm_imads(n, f, b, lanes) for n, f, b, _, lanes in rows)
    nbytes = sum(msm_bytes(n, f, fr, lanes) for n, f, _, fr, lanes in rows)
    t_ops, t_bytes = imads / IMAD_PER_S, nbytes / HBM_BYTES_PER_S
    return (t_ops, "operations", imads, nbytes) if t_ops >= t_bytes else (t_bytes, "bytes", imads, nbytes)
