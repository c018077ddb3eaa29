"""The port's v1 classified MSM (msm.msm) on the CPU.

Tier-1: the sum equals the host curve's on G1 and G2, with zero, one and
general scalars over more than one 64-row tile, so the boolean and the
Pippenger partials and the combine all run.  The host curves are the
port's copies, held bit for bit against the JAX package in
tests/test_torch_curves.py.  Under RUN_SLOW the result also equals
zkmember_tpu.msm.msm.msm on the same points and scalars (the JAX v1 MSM
under XLA on the CPU takes minutes).
"""

import os
import random

import pytest
import torch

from zkmember_tpu_torch.curves import bls12_381 as bls
from zkmember_tpu_torch.curves import device as cdv
from zkmember_tpu_torch.fields import spec as fs
from zkmember_tpu_torch.msm import msm


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _case(g2: bool, count: int, seed: int):
    rng = random.Random(seed)
    curve, gen = (bls.G2, bls.G2_GEN) if g2 else (bls.G1, bls.G1_GEN)
    P = curve.mul(rng.randrange(1, bls.R), gen)
    step = curve.mul(rng.randrange(1, bls.R), gen)
    pts = []
    for _ in range(count):
        pts.append(P)
        P = curve.add(P, step)
    scalars = [rng.choice([0, 1, rng.randrange(bls.R), bls.R - 1]) for _ in range(count)]
    pa = (msm.g2_points_from_host(fs.BLS_FQ2, curve, pts, "cpu") if g2
          else msm.g1_points_from_host(fs.BLS_FQ, curve, pts, "cpu"))
    return curve, pts, scalars, pa


def _host_msm(curve, pts, scalars):
    acc = None
    for s, p in zip(scalars, pts):
        acc = curve.add(acc, curve.mul(s % bls.R, p))
    return acc


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_msm_equals_host_sum(g2):
    curve, pts, scalars, pa = _case(g2, 70, 1)
    assert msm.tile("cpu") == 64 and len(pts) > msm.tile("cpu")
    assert {0, 1} <= set(scalars) and any(s > 1 for s in scalars)
    assert msm.msm(pa, scalars, bls.R) == _host_msm(curve, pts, scalars)


def test_msm_classes_alone():
    curve, pts, _, pa = _case(False, 9, 2)
    assert msm.msm(pa, [0] * 9, bls.R) is None
    ones = [1, 0, 1, 1, 0, 0, 1, 1, 1]
    assert msm.msm(pa, ones, bls.R) == _host_msm(curve, pts, ones)
    # 7 P + (r - 7) P is the identity
    twice = msm.PointArray(pa.F, curve, pa.x[[3, 3]], pa.y[[3, 3]])
    assert msm.msm(twice, [7, bls.R - 7], bls.R) is None


def test_digit_helpers():
    from zkmember_tpu_torch import native as zknative

    vals = [0, 1, 0xABCDEF, bls.R - 1]
    rows = zknative.ints_to_u64(vals, 4)
    nib = msm.u64_rows_to_digits(rows, 255)
    by = msm.u64_rows_to_bytes(rows, 255)
    for v, n, b in zip(vals, nib, by):
        assert sum(int(d) << (4 * i) for i, d in enumerate(n[::-1])) == v
        assert sum(int(d) << (8 * i) for i, d in enumerate(b[::-1])) == v
    assert (msm.scalars_to_digits_np(vals, 255) == nib).all()
    assert cdv.b3_of(bls.G1) == 12 and cdv.b3_of(bls.G2) == (12, 12)


@pytest.mark.skipif(not os.environ.get("RUN_SLOW"),
                    reason="the JAX v1 MSM takes minutes on the CPU; RUN_SLOW=1")
@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_msm_equals_reference(g2):
    from zkmember_tpu.curves import bls12_381 as jbls
    from zkmember_tpu.fields import device as jdv
    from zkmember_tpu.msm import msm as jmsm

    curve, pts, scalars, pa = _case(g2, 70, 3)
    if g2:
        jpts = [tuple(jbls.fq2(*(int(c.v) for c in xy.coeffs)) for xy in p) for p in pts]
        jpa = jmsm.g2_points_from_host(jdv.BLS_FQ2, jbls.G2, jpts)
    else:
        jpts = [(jbls.Fq(int(p[0].v)), jbls.Fq(int(p[1].v))) for p in pts]
        jpa = jmsm.g1_points_from_host(jdv.BLS_FQ, jbls.G1, jpts)
    want = jmsm.msm(jpa, scalars, jbls.R)
    got = msm.msm(pa, scalars, bls.R)

    def ints(pt):
        return [[int(c.v) for c in x.coeffs] if hasattr(x, "coeffs") else int(x.v) for x in pt]

    assert ints(got) == ints(want)
