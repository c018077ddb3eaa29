"""Embedded twisted Edwards curve over BW6-761's scalar field (= BLS12-377 Fq).

Fills the role of `ark-ed-on-bw6-761` in the reference's pedersen761 stack
(SURVEY.md section 2.2 row 2; use site
src/commitments/pedersen761/common.rs:17): the Pedersen CRH
for the BW6-761 configuration hashes on an Edwards curve whose base field is
BW6-761's Fr, so the hash gadget is native to BW6-761 circuits.

Parameters follow `ark-ed-on-bw6-761` (a re-export of ark-ed-on-cp6-782):
a = -1, d = 79743, cofactor 8 — so points/digests are parameter-compatible
with the reference stack (pedersen761/common.rs:17).  d is verified
non-square over this field at import (completeness of the unified law).
The generator is derived by lifting the smallest valid y and clearing the
cofactor (the reference's Pedersen tables are RNG-sampled multiples of a
random point, so the distinguished generator never enters any hash).
"""

from __future__ import annotations

from zkmember_tpu_torch.curves.bw6_761 import Fr, R
from zkmember_tpu_torch.curves.host import TECurve

P = R  # base field modulus (377 bits)
Fq = Fr

assert P % 4 == 1  # -1 is a square -> a = -1 keeps the law complete

A = Fq(-1)
D = Fq(79743)  # ark-ed-on-cp6-782 COEFF_D
assert pow(D.v, (P - 1) // 2, P) != 1, "d must be non-square (complete law)"
COFACTOR = 8  # torsion-clearing factor used when sampling points

CURVE = TECurve(Fq, A, D, cofactor=COFACTOR, name="Ed377")


def _find_generator():
    y = 2
    while True:
        pt = CURVE.lift_y(Fq(y), x_sign=0)
        if pt is not None:
            g = CURVE.mul(COFACTOR, pt)
            if not CURVE.is_identity(g):
                return g
        y += 1


GENERATOR = _find_generator()
CURVE.generator = GENERATOR
