"""The port's Straus MSM at BW6-761 width (Fq of 48 limbs, Fp for both
groups): kernel K1's plain version and the plain finish against the JAX
reference's XLA composition and a host bignum MSM.

G1 is y^2 = x^3 - 1 (b3 = -3: the first negative b3 the kernels meet) and
G2 the twist y^2 = x^3 + 4 over the same Fq (b3 = 12).  Points and scalars
come from seeded generators; points are compared after normalisation.  The
CUDA kernels are held against these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import random

import numpy as np
import pytest
import torch

from zkmember_tpu.curves import bw6_761 as jbw6, device as jcdv
from zkmember_tpu.fields import device as dv, lm as jlm
from zkmember_tpu.msm import straus as jstraus
from zkmember_tpu_torch import kernels
from zkmember_tpu_torch.curves import bw6_761 as bw6
from zkmember_tpu_torch.fields import spec as fs
from zkmember_tpu_torch.msm import finish_cuda, select_reduce_cuda as k1, straus
from zkmember_tpu_torch.snark import groth16, prove_lm

GROUPS = [(False, -3), (True, 12)]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).astype(np.int32))


def _curve(g2):
    return (bw6.G2, bw6.G2_GEN, jbw6.G2) if g2 else (bw6.G1, bw6.G1_GEN, jbw6.G1)


def _ops(g2):
    return prove_lm.sw_ops(groth16.pairing_config("bw6_761"), g2, "cpu")


def _jops(g2, b3):
    return jcdv.sw_ops_for(jlm.FpOpsLM(dv.BW6_FQ), b3, f"bw6_761_{'g2' if g2 else 'g1'}/lm")


def _ints(pt):
    return None if pt is None else (int(pt[0].v), int(pt[1].v))


def _planes(pts):
    X = fs.to_lm(fs.BW6_FQ.to_mont_host([p[0].v for p in pts]))
    Y = fs.to_lm(fs.BW6_FQ.to_mont_host([p[1].v for p in pts]))
    return np.ascontiguousarray(X), np.ascontiguousarray(Y)


@pytest.mark.parametrize("g2,b3", GROUPS, ids=["g1", "g2"])
def test_select_reduce_plain_matches_reference_and_host(g2, b3):
    """B = 64 lanes (tiles of 32 threads x 2 lanes), 4 windows: each
    window's lane sum equals the JAX window_sums, and the Horner join the
    JAX horner_join of those sums (msm_program's composition) and a host
    MSM."""
    nwin, B = 4, 64
    curve, gen, jcurve = _curve(g2)
    rng = random.Random(40 + g2)
    step = curve.mul(rng.randrange(1, bw6.R), gen)
    pts = [curve.mul(rng.randrange(1, bw6.R), gen)]
    for _ in range(B - 1):
        pts.append(curve.add(pts[-1], step))
    scalars = [rng.randrange(1 << (4 * nwin)) for _ in range(B)]
    X, Y = _planes(pts)
    z = np.ascontiguousarray(fs.to_lm(fs.ints_to_limbs(scalars, fs.BW6_FR.n)))
    ops = _ops(g2)
    assert ops.b3 == b3 and ops.F.spec == fs.BW6_FQ
    tab = straus.table_program(ops, _t(X), _t(Y))
    assert tuple(tab.shape) == (16, 1, B, 3 * 24)
    digits = straus.digits_from_limbs(_t(z), nwin).contiguous()[:, None]  # (W, 1, B)
    S = k1.select_reduce_plain(ops, tab, digits)
    assert S[0].shape == (nwin, 1, 48, 32)
    S = straus.tree_reduce_lanes(ops, tuple(c[:, 0] for c in S))  # (W, n, 1)

    jops = _jops(g2, b3)
    want_S = jstraus.window_sums(jops, X, Y, z, nwin)  # (W, n, 1), MSW first
    for w in range(nwin):
        got_w = straus.projective_to_host(curve, tuple(c[w].numpy() for c in S))
        want_w = jstraus.projective_to_host(None, jcurve, tuple(np.asarray(c[w]) for c in want_S))
        assert _ints(got_w) == _ints(want_w), w

    got = straus.projective_to_host(curve, tuple(c.numpy() for c in straus.horner_join(ops, S)))
    want = jstraus.projective_to_host(None, jcurve, jstraus.horner_join(jops, want_S))
    host = curve.mul(sum(s * k for s, k in zip(scalars, range(B))) % bw6.R, step)
    host = curve.add(host, curve.mul(sum(scalars) % bw6.R, pts[0]))
    assert _ints(got) == _ints(want) == _ints(host)


def _window_sums(g2: bool, W: int, R: int, NT: int, seed: int):
    """(W, R, n, NT) planes of random projective points k G (a random Z),
    and the host MSM of each row, sum_w 16^(W-1-w) sum_i k_(w,r,i) G."""
    rng = np.random.default_rng(seed)
    curve, gen, _ = _curve(g2)
    q = fs.BW6_FQ.p
    ks = rng.integers(1, 1 << 62, size=(W, R, NT)).tolist()
    base = curve.mul(int(rng.integers(1, 1 << 62)), gen)
    coords = [[], [], []]
    for k in (k for kw in ks for kr in kw for k in kr):
        x, y = curve.mul(k, base)
        z = int(rng.integers(1, 1 << 62))
        for c, v in zip(coords, (x.v * z % q, y.v * z % q, z)):
            c.append(v)
    planes = tuple(np.ascontiguousarray(fs.to_lm(fs.BW6_FQ.to_mont_host(c).reshape(W, R, NT, 48)))
                   for c in coords)
    want = [curve.mul(sum(16 ** (W - 1 - w) * sum(ks[w][r]) for w in range(W)) % bw6.R, base)
            for r in range(R)]
    return planes, want


@pytest.mark.parametrize("g2,b3", GROUPS, ids=["g1", "g2"])
def test_plain_finish_matches_reference_and_host(g2, b3):
    """The proof's 95 windows (W odd, not a power of two), NT = 2 lanes."""
    W, R, NT = 95, 1, 2
    S, want = _window_sums(g2, W, R, NT, seed=61 + g2)
    got = finish_cuda.msm_finish_plain(_ops(g2), tuple(_t(c) for c in S))
    jops = _jops(g2, b3)
    ref = jstraus.horner_join(jops, jstraus.tree_reduce_lanes(jops, S))
    curve, _, jcurve = _curve(g2)
    for r in range(R):
        mine = straus.projective_to_host(curve, tuple(c[r].numpy() for c in got))
        theirs = jstraus.projective_to_host(None, jcurve, tuple(np.asarray(c[r]) for c in ref))
        assert _ints(mine) == _ints(theirs) == _ints(want[r]), r


def _boom(*args, **kwargs):
    raise AssertionError("a CUDA kernel was reached")


@pytest.mark.parametrize("n,fp2,name", [
    (24, False, "select_reduce_fp"), (24, True, "select_reduce_fp2"),
    (48, False, "select_reduce_fp48"), (48, True, None), (16, False, None),
], ids=["fp24", "fp2_24", "fp48", "fp2_48", "fp16"])
def test_kernel_variants(n, fp2, name):
    """The built variants: Fp at n = 24 and 48, Fp2 at n = 24; the launch
    counts have a name for each; any other field raises."""
    if name is None:
        with pytest.raises(ValueError, match="not Fp"):
            k1.variant("select_reduce", fp2, n)
    else:
        assert k1.variant("select_reduce", fp2, n) == name
        assert name in kernels.LAUNCHES
        assert name.replace("select_reduce", "msm_finish") in kernels.LAUNCHES


def test_wrappers_reject_an_unsupported_field_before_launch(monkeypatch):
    """K1 and the finish over a field the kernels are not built for (n = 16,
    BLS12-381 Fr): both raise before any launch."""
    monkeypatch.setattr(kernels, "library", _boom)
    from zkmember_tpu_torch.curves import device as cdv
    from zkmember_tpu_torch.fields import lm

    ops = cdv.SWOps(lm.FpOpsLM(fs.BLS_FR, "cpu"), 3, "bls12_381_fr/lm")
    planes = tuple(torch.zeros((4, 1, 16, 8), dtype=torch.int32) for _ in range(3))
    with pytest.raises(ValueError, match="n = 16"):
        finish_cuda.msm_finish_cuda(ops, planes)
    records = torch.zeros((16, 1, 64, 3 * 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="n = 16"):
        k1.select_reduce_cuda(ops, records, torch.zeros((4, 1, 1, 64), dtype=torch.int32))
