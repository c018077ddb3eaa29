"""The port's MSM finish (tail reduction plus Horner join,
``msm/finish_cuda.py``) against the JAX reference's XLA
``straus.tree_reduce_lanes`` + ``straus.horner_join`` on the same window
sums, and against a host bignum MSM.  The port adds the lanes chunk by
chunk (``finish_cuda.TAIL_CHUNK``) and doubles with the a = 0 doubling, so
the two agree as points, not as projective coordinates.

The window sums are seeded random points k G in projective form with a
random Z, so the expected result of row r is (sum_w 16^(W-1-w) sum_i
k_{w,r,i}) G.  Points are compared after normalisation.  The CUDA kernel
itself is held against the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from zkmember_tpu.curves import bls12_381 as jbls, device as jcdv
from zkmember_tpu.fields import device as dv, lm as jlm
from zkmember_tpu.msm import straus as jstraus
from zkmember_tpu_torch import kernels
from zkmember_tpu_torch.curves import bls12_381 as bls, device as cdv
from zkmember_tpu_torch.fields import spec as fs
from zkmember_tpu_torch.msm import finish_cuda, select_reduce_cuda, straus
from zkmember_tpu_torch.snark import groth16, prove_lm


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _boom(*args, **kwargs):
    raise AssertionError("a CUDA kernel was reached")


def _window_sums(g2: bool, W: int, R: int, NT: int, seed: int, zero_windows=()):
    """Coordinates of (W, R, n, NT) u32 planes of random projective points
    k G, and the host MSM of each row.  Windows in `zero_windows` hold the
    identity (0 : 1 : 0) in every lane."""
    rng = np.random.default_rng(seed)
    curve, gen = (bls.G2, bls.G2_GEN) if g2 else (bls.G1, bls.G1_GEN)
    q = fs.BLS_FQ.p
    ks = rng.integers(1, 1 << 62, size=(W, R, NT))
    ks[list(zero_windows)] = 0
    ks = ks.tolist()
    coords = [[] for _ in range(6 if g2 else 3)]
    for k in (k for kw in ks for kr in kw for k in kr):
        z = [int(v) for v in rng.integers(1, 1 << 62, size=2)]
        if k == 0:
            vals = [0, 0, 1, 0, 0, 0] if g2 else [0, 1, 0]
        elif g2:
            x, y = curve.mul(k, gen)
            zf = bls.fq2(*z)
            vals = [c for e in (x * zf, y * zf, zf) for c in (e.coeffs[0].v, e.coeffs[1].v)]
        else:
            x, y = curve.mul(k, gen)
            vals = [x.v * z[0] % q, y.v * z[0] % q, z[0]]
        for c, v in zip(coords, vals):
            c.append(v)
    planes = [np.ascontiguousarray(fs.to_lm(fs.BLS_FQ.to_mont_host(c).reshape(W, R, NT, 24)))
              for c in coords]
    if g2:
        planes = [(planes[2 * i], planes[2 * i + 1]) for i in range(3)]
    want = []
    for r in range(R):
        s = sum(16 ** (W - 1 - w) * sum(ks[w][r]) for w in range(W)) % bls.R
        want.append(curve.mul(s, gen))
    return tuple(planes), want


def _map(f, c):
    return tuple(_map(f, ci) for ci in c) if isinstance(c, tuple) else f(c)


def _map2(f, a, b):
    return tuple(_map2(f, x, y) for x, y in zip(a, b)) if isinstance(a, tuple) else f(a, b)


def _ints(pt):
    if pt is None:
        return None
    return tuple(tuple(int(c.v) for c in v.coeffs) if hasattr(v, "coeffs") else int(v.v) for v in pt)


def _jops(g2):
    if g2:
        return jcdv.sw_ops_for(jlm.Fp2OpsLM(dv.BLS_FQ2), (12, 12), "bls12_381_g2/lm")
    return jcdv.sw_ops_for(jlm.FpOpsLM(dv.BLS_FQ), 12, "bls12_381_g1/lm")


# (g2, W, R, NT, windows of identities): NT = 512 runs the reference's
# contiguous halvings (NT > 256) and two of the port's chunk stages
@pytest.mark.parametrize("g2,W,R,NT,zeros", [
    (False, 8, 2, 8, ()), (True, 8, 1, 8, ()), (False, 1, 1, 512, ()), (True, 3, 1, 8, (1,)),
    (False, 4, 2, 8, (0, 2)),
], ids=["g1", "g2", "g1_nt512", "g2_identity_window", "g1_identity_windows"])
def test_plain_finish_matches_reference_and_host(g2, W, R, NT, zeros):
    S, want = _window_sums(g2, W, R, NT, seed=31 + g2 + NT, zero_windows=zeros)
    ops = prove_lm.sw_ops(groth16.pairing_config("bls12_381"), g2, "cpu")
    got = finish_cuda.msm_finish_plain(ops, _map(lambda a: torch.from_numpy(a.astype(np.int32)), S))
    jops = _jops(g2)
    ref = jstraus.horner_join(jops, jstraus.tree_reduce_lanes(jops, S))
    curve, jcurve = (bls.G2, jbls.G2) if g2 else (bls.G1, jbls.G1)
    for r in range(R):
        mine = straus.projective_to_host(curve, _map(lambda c: c[r].numpy(), got))
        theirs = jstraus.projective_to_host(None, jcurve, _map(lambda c: np.asarray(c[r]), ref))
        assert _ints(mine) == _ints(theirs) == _ints(want[r]), r


def test_msm_on_cpu_tensors_never_reaches_a_kernel(monkeypatch):
    monkeypatch.setattr(kernels, "library", _boom)
    monkeypatch.setattr(finish_cuda, "msm_finish_cuda", _boom)
    monkeypatch.setattr(select_reduce_cuda, "select_reduce_cuda", _boom)
    rng = np.random.default_rng(7)
    B, nwin = 64, 4
    ks = [int(k) for k in rng.integers(1, 1 << 62, size=B)]
    scalars = [int(s) for s in rng.integers(0, 1 << 16, size=B)]
    pts = [bls.G1.mul(k, bls.G1_GEN) for k in ks]
    X = fs.to_lm(fs.BLS_FQ.to_mont_host([p[0].v for p in pts]))
    Y = fs.to_lm(fs.BLS_FQ.to_mont_host([p[1].v for p in pts]))
    z = fs.to_lm(fs.ints_to_limbs(scalars, 16))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a).astype(np.int32))  # noqa: E731
    ops = prove_lm.sw_ops(groth16.pairing_config("bls12_381"), False, "cpu")
    tab = straus.table_program(ops, t(X), t(Y))
    phases = []
    out = straus.msm_precomp_program(ops, tab, nwin, t(z), mark=phases.append, prefix="g1_")
    assert phases == ["g1_select_reduce", "g1_finish"]
    got = straus.projective_to_host(bls.G1, tuple(c.numpy() for c in out))
    want = bls.G1.mul(sum(s * k for s, k in zip(scalars, ks)) % bls.R, bls.G1_GEN)
    assert _ints(got) == _ints(want)


@pytest.mark.parametrize("case", ["nt_not_pow2", "n16", "no_rows", "coords", "cpu"])
def test_finish_wrapper_rejects_bad_shapes_before_launch(monkeypatch, case):
    monkeypatch.setattr(kernels, "library", _boom)
    ops = prove_lm.sw_ops(groth16.pairing_config("bls12_381"), False, "cpu")
    W, R, n, NT = 4, 2, 24, 8
    shapes = {"nt_not_pow2": (W, R, n, 6), "n16": (W, R, 16, NT), "no_rows": (W, 0, n, NT),
              "coords": (W, R, n, NT), "cpu": (W, R, n, NT)}
    planes = tuple(torch.zeros(shapes[case], dtype=torch.int32) for _ in range(3))
    if case == "coords":
        planes = planes[:2]
    match = {"nt_not_pow2": "power of two", "n16": "n = 24", "no_rows": "R = 0",
             "coords": "3 coordinates", "cpu": "CUDA device"}[case]
    with pytest.raises(ValueError, match=match):
        finish_cuda.msm_finish_cuda(ops, planes)


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_swp_double_matches_reference_bit_for_bit(g2):
    """The join's doubling (RCB15 Alg. 9): the port's swp_double gives the
    JAX swp_double's projective coordinates on points with a random Z and
    on the identity, and doubles as the host curve does."""
    pts, _ = _window_sums(g2, 1, 1, 5, seed=5 + g2)
    ident, _ = _window_sums(g2, 1, 1, 1, seed=6, zero_windows=(0,))
    S = _map2(lambda a, b: np.concatenate([a[0, 0], b[0, 0]], axis=-1), pts, ident)  # (n, 6)
    ops = prove_lm.sw_ops(groth16.pairing_config("bls12_381"), g2, "cpu")
    got = cdv.swp_double(ops, _map(lambda a: torch.from_numpy(a.astype(np.int32)), S))
    want = jcdv.swp_double(_jops(g2), S)
    flat = lambda P: [c for x in P for c in (x if isinstance(x, tuple) else (x,))]  # noqa: E731
    for g, w in zip(flat(got), flat(want)):
        assert np.array_equal(g.numpy().astype(np.int64), np.asarray(w).astype(np.int64))
    curve = bls.G2 if g2 else bls.G1
    for lane in range(6):
        pt = straus.projective_to_host(curve, _map(lambda c: c[..., lane : lane + 1], S))
        dbl = straus.projective_to_host(curve, _map(lambda c: c[..., lane : lane + 1].numpy(), got))
        assert _ints(dbl) == _ints(None if pt is None else curve.double(pt)), lane


@pytest.mark.parametrize("NT,want", [
    (1, (0, 0)), (64, (0, 0)), (512, (2 * 64, 2 * 1)),
    (1024, (2 * 128 + 2 * 16, 2 * 2 + 2 * 1)),
    (8192, (2 * 1024 + 2 * 128 + 2 * 16, 2 * 16 + 2 * 2 + 2 * 1)),
])
def test_tail_scratch_counts_the_kernels_stages(NT, want):
    """Records a tail stage hands to a later one (8 partial sums a chunk of
    64 lanes, while a window is wider than a chunk) and counters (one a
    chunk of those), for two windows."""
    assert (finish_cuda.TAIL_CHUNK, finish_cuda.TAIL_KEEP) == (64, 8)
    assert finish_cuda.tail_scratch(2, NT) == want
