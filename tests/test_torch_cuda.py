"""Card-side checks of the hand-written CUDA kernels against their plain versions.

Imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Every test decides inside itself whether a card is present and skips
without one (as on the CPU-only test host).
"""

import random

import numpy as np
import pytest
import torch

from zkmember_tpu_torch import kernels
from zkmember_tpu_torch.curves import bls12_381 as bls
from zkmember_tpu_torch.fields import field_cuda, lm_cuda, spec as fs
from zkmember_tpu_torch.msm import finish_cuda, select_reduce_cuda as k1, straus
from zkmember_tpu_torch.snark import groth16, prove_lm

pytestmark = pytest.mark.cuda


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")


def _planes(spec, shape, seed):
    rng = np.random.default_rng(seed)
    K, n, B = shape
    limbs = rng.integers(0, 1 << 16, size=(K, n, B), dtype=np.int64)
    limbs[:, n - 1, :] %= int(spec.p_limbs[-1])  # value < p
    return torch.as_tensor(limbs, dtype=torch.int32, device="cuda")


@pytest.mark.parametrize("spec", [fs.BLS_FR, fs.BLS_FQ, fs.BW6_FQ], ids=lambda s: s.name)
def test_mont_mul_kernel_matches_plain(spec):
    _need_card()
    a = _planes(spec, (2, spec.n, 1000), 1)
    b = _planes(spec, (2, spec.n, 1000), 2)
    before = kernels.LAUNCHES["mont_mul"]
    got = lm_cuda.mont_mul(spec, a, b)
    assert kernels.LAUNCHES["mont_mul"] == before + 1
    assert torch.equal(got, lm_cuda.mont_mul_plain(spec, a, b))
    # broadcast constant column
    c = b[0, :, :1]
    assert torch.equal(lm_cuda.mont_mul(spec, a, c), lm_cuda.mont_mul_plain(spec, a, c))


# (a's shape, b's shape) with n = -1 for the limb axis: the H pipeline's
# broadcast patterns, an odd lane count, K = 1 and B = 1
K2_PATTERNS = [((3, -1, 501), (-1, 501)), ((-1, 501), (-1, 501)), ((3, -1, 1002), (-1, 1)),
               ((3, -1, 1002), (-1, 1002)), ((-1, 1002), (-1, 1)), ((-1, 1), (-1, 1)),
               ((5, -1, 1), (-1, 1)), ((1, -1, 333), (4, -1, 333))]


def _fill(shape, n):
    return tuple(n if d == -1 else d for d in shape)


@pytest.mark.parametrize("sa,sb", K2_PATTERNS, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("spec", [fs.BLS_FR, fs.BLS_FQ, fs.BW6_FQ], ids=lambda s: s.name)
def test_mont_mul_kernel_broadcast_patterns(spec, sa, sb):
    _need_card()
    sa, sb = _fill(sa, spec.n), _fill(sb, spec.n)

    def planes(shape, seed):
        lead = int(np.prod(shape[:-2]))
        return _planes(spec, (lead, spec.n, shape[-1]), seed).reshape(shape)

    a, b = planes(sa, 11), planes(sb, 12)
    g = lm_cuda.launch_args(spec.n, a.shape, a.stride(), b.shape, b.stride())
    assert not g.copy_a and not g.copy_b
    got = lm_cuda.mont_mul(spec, a, b)
    assert torch.equal(got, lm_cuda.mont_mul_plain(spec, a, b))
    assert torch.equal(lm_cuda.mont_mul(spec, b, a), got)


def test_broadcast_operands_are_not_copied():
    """A broadcast operand costs the card the output's bytes and nothing more."""
    _need_card()
    spec = fs.BLS_FR
    a = _planes(spec, (3, spec.n, 4096), 13)
    for b in (a[0], a[0, :, :1]):  # stage twiddles (n, B), a constant column (n, 1)
        lm_cuda.mont_mul(spec, a, b)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        out = lm_cuda.mont_mul(spec, a, b)
        torch.cuda.synchronize()
        assert torch.cuda.max_memory_allocated() - before == out.numel() * 4
    rows = a.reshape(3, -1, spec.n)  # batch-major (3, rows, n)
    for b in (rows[0], rows[0, 7]):  # a (rows, n) table, an (n,) constant
        field_cuda.mont_mul_bm(spec, rows, b)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        out = field_cuda.mont_mul_bm(spec, rows, b)
        torch.cuda.synchronize()
        assert torch.cuda.max_memory_allocated() - before == out.numel() * 4


def test_mont_mul_kernel_rejects_bad_planes():
    _need_card()
    spec = fs.BLS_FQ
    a = _planes(spec, (1, spec.n, 64), 3)
    with pytest.raises(TypeError):
        lm_cuda.mont_mul_cuda(spec, a.long(), a.long())
    with pytest.raises(ValueError):
        lm_cuda.mont_mul_cuda(fs.BLS_FR, a, a)


def test_cuda_tensors_never_take_the_plain_version(monkeypatch):
    _need_card()

    def boom(*args):
        raise AssertionError("plain version used for CUDA tensors")

    monkeypatch.setattr(lm_cuda, "mont_mul_plain", boom)
    monkeypatch.setattr(k1, "select_reduce_plain", boom)
    monkeypatch.setattr(field_cuda, "mont_mul_bm_plain", boom)
    monkeypatch.setattr(finish_cuda, "msm_finish_plain", boom)
    spec = fs.BLS_FQ
    a = _planes(spec, (1, spec.n, 64), 4)
    lm_cuda.mont_mul(spec, a, a)
    field_cuda.mont_mul_bm(spec, a[0].T, a[0].T)
    ops = prove_lm.sw_ops(groth16.pairing_config("bls12_381"), False, "cuda")
    finish_cuda.msm_finish(ops, tuple(_planes(spec, (2, spec.n, 4), 5 + i) for i in range(3)))


@pytest.mark.parametrize("spec", [fs.BLS_FR, fs.BLS_FQ, fs.BW6_FQ], ids=lambda s: s.name)
def test_mont_mul_bm_kernel_matches_plain(spec):
    _need_card()
    a = _planes(spec, (1, spec.n, 1000), 5)[0].T.reshape(2, 500, spec.n)  # batch-major rows
    b = _planes(spec, (1, spec.n, 1000), 6)[0].T.reshape(2, 500, spec.n)
    pm1 = spec.p_limbs.astype(np.int64)
    pm1[0] -= 1
    a[0, 0] = 0  # the rows 0 and p - 1
    a[0, 1] = torch.as_tensor(pm1, dtype=torch.int32)
    before = kernels.LAUNCHES["mont_mul_bm"]
    got = field_cuda.mont_mul_bm(spec, a, b)
    assert kernels.LAUNCHES["mont_mul_bm"] == before + 1
    assert torch.equal(got, field_cuda.mont_mul_bm_plain(spec, a, b))
    # a broadcast (n,) constant and a (500, n) table against (2, 500, n) rows
    for c in (b[1, 7], b[1]):
        assert torch.equal(field_cuda.mont_mul_bm(spec, a, c), field_cuda.mont_mul_bm_plain(spec, a, c))
    # a ragged row count (not a multiple of the block's rows)
    assert torch.equal(field_cuda.mont_mul_bm(spec, a[0, :131], b[0, :131]),
                       field_cuda.mont_mul_bm_plain(spec, a[0, :131], b[0, :131]))


@pytest.mark.parametrize("spec", [fs.BLS_FR, fs.BLS_FQ, fs.BW6_FQ], ids=lambda s: s.name)
def test_mont_mul_bm_kernel_broadcast_patterns(spec):
    _need_card()
    rows = 4 * 131  # a quarter of the rows (131) is not a multiple of a block's
    a = _planes(spec, (1, spec.n, rows), 14)[0].T.contiguous()
    b = _planes(spec, (1, spec.n, rows), 15)[0].T.contiguous()
    stack = a[: 3 * rows // 4].reshape(3, rows // 4, spec.n)
    table = b[: rows // 4]
    for x, y in ((stack, b[9]), (stack, table), (a, b[3]), (b[3], a)):
        g = field_cuda.launch_args(spec.n, x.shape, x.stride(), x.data_ptr() % 16 == 0,
                                   y.shape, y.stride(), y.data_ptr() % 16 == 0)
        assert not g.copy_a and not g.copy_b
        assert torch.equal(field_cuda.mont_mul_bm(spec, x, y),
                           field_cuda.mont_mul_bm_plain(spec, x, y))
    # operands the kernel cannot read in place are copied first: limbs not
    # contiguous, a row start off 16 bytes
    t = _planes(spec, (1, spec.n, 64), 16)[0].T
    off = a.reshape(-1)[1 : 1 + 64 * spec.n].reshape(64, spec.n)
    for x in (t, off):
        assert torch.equal(field_cuda.mont_mul_bm(spec, x, b[:64]),
                           field_cuda.mont_mul_bm_plain(spec, x, b[:64]))


def test_mont_mul_bm_kernel_rejects_bad_rows():
    _need_card()
    spec = fs.BLS_FQ
    a = _planes(spec, (1, spec.n, 64), 7)[0].T.contiguous()
    with pytest.raises(TypeError):
        field_cuda.mont_mul_bm_cuda(spec, a.long(), a.long())
    with pytest.raises(ValueError):
        field_cuda.mont_mul_bm_cuda(fs.BLS_FR, a, a)


def _k1_table(g2, rows, B):
    """K1's packed table of `rows` rows of B points on the card; row r holds
    the points rolled by 7 r lanes, so a wrong row offset shows."""
    rng = random.Random(5)
    curve, gen = (bls.G2, bls.G2_GEN) if g2 else (bls.G1, bls.G1_GEN)
    P = curve.mul(rng.randrange(1, bls.R), gen)
    step = curve.mul(rng.randrange(1, bls.R), gen)
    pts = []
    for _ in range(B):
        pts.append(P)
        P = curve.add(P, step)

    def dev(vals):
        return torch.as_tensor(fs.to_lm(fs.BLS_FQ.to_mont_host(vals)).astype(np.int64),
                               dtype=torch.int32, device="cuda")

    if g2:
        X = tuple(dev([p[0].coeffs[i].v for p in pts]) for i in range(2))
        Y = tuple(dev([p[1].coeffs[i].v for p in pts]) for i in range(2))
    else:
        X, Y = dev([p[0].v for p in pts]), dev([p[1].v for p in pts])
    ops = prove_lm.sw_ops(groth16.pairing_config("bls12_381"), g2, "cuda")
    roll = lambda c, r: torch.roll(c, 7 * r, dims=-1)  # noqa: E731
    tabs = [straus.table_program(ops, straus._map_coord(lambda c: roll(c, r), X),
                                 straus._map_coord(lambda c: roll(c, r), Y))
            for r in range(rows)]
    return ops, torch.cat(tabs, 1).contiguous()  # R records (16, 1, B, .) -> (16, R, B, .)


def _flat(S):
    return [c for x in S for c in (x if isinstance(x, tuple) else (x,))]


# (W, B): one tile; a window count that is not a multiple of the warps of a
# block (4 for Fp, 2 for Fp2); two tiles
@pytest.mark.parametrize("W,B", [(4, 256), (3, 512), (3, 1024)])
@pytest.mark.parametrize("rows", [1, 3])
@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_select_reduce_kernel_matches_plain(g2, rows, W, B):
    _need_card()
    ops, tab = _k1_table(g2, rows, B)
    digits = torch.randint(0, 16, (W, rows, B), dtype=torch.int32, device="cuda")
    name = "select_reduce_fp2" if g2 else "select_reduce_fp"
    before = kernels.LAUNCHES[name]
    got = k1.select_reduce(ops, tab, digits)
    assert kernels.LAUNCHES[name] == before + 1
    want = k1.select_reduce_plain(ops, tab, digits)
    for g, w in zip(_flat(got), _flat(want)):
        assert torch.equal(g, w)
    with pytest.raises(ValueError):
        k1.select_reduce_cuda(ops, tab, digits[..., :32].contiguous())


@pytest.mark.parametrize("P", [1, 3])
@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_select_reduce_kernel_proof_axis(g2, P):
    """Digits (W, P, R, B), the proof-batch axis: one launch equals the
    plain version limb for limb, and proof p's sums equal a launch on its
    (W, R, B) digits alone."""
    _need_card()
    W, rows, B = 3, 2, 1024
    ops, tab = _k1_table(g2, rows, B)
    digits = torch.randint(0, 16, (W, P, rows, B), dtype=torch.int32, device="cuda")
    name = "select_reduce_fp2" if g2 else "select_reduce_fp"
    before = kernels.LAUNCHES[name]
    got = k1.select_reduce(ops, tab, digits)
    assert kernels.LAUNCHES[name] == before + 1
    want = k1.select_reduce_plain(ops, tab, digits)
    for g, w in zip(_flat(got), _flat(want)):
        assert g.shape == (W, P, rows, 24, B // 16)
        assert torch.equal(g, w)
    for p in range(P):
        one = k1.select_reduce_cuda(ops, tab, digits[:, p].contiguous())
        assert all(torch.equal(g[:, p], o) for g, o in zip(_flat(got), _flat(one)))


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_select_reduce_kernel_rejects_batched_digits_off_the_table(g2):
    """4-D digits must be (W, P, R, B) with the table's R and B: the proof and
    row axes swapped, another row count or lane count, or 5-D digits are
    refused before any launch."""
    _need_card()
    W, rows, B = 2, 2, 512
    ops, tab = _k1_table(g2, rows, B)
    name = "select_reduce_fp2" if g2 else "select_reduce_fp"
    before = kernels.LAUNCHES[name]
    for shape in ((W, rows, 3, B), (W, 3, rows + 1, B), (W, 3, rows, B // 2), (W, 1, 3, rows, B)):
        digits = torch.zeros(shape, dtype=torch.int32, device="cuda")
        with pytest.raises(ValueError):
            k1.select_reduce_cuda(ops, tab, digits)
    assert kernels.LAUNCHES[name] == before


# (W, R, NT): even/odd rounds only; contiguous halvings before them (NT > 256)
@pytest.mark.parametrize("W,R,NT", [(3, 2, 8), (2, 1, 1024)])
@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_msm_finish_kernel_matches_plain(g2, W, R, NT):
    _need_card()
    spec = fs.BLS_FQ
    ops = prove_lm.sw_ops(groth16.pairing_config("bls12_381"), g2, "cuda")
    # any field elements will do: both versions run the same arithmetic
    planes = [_planes(spec, (W * R, spec.n, NT), 20 + i).reshape(W, R, spec.n, NT)
              for i in range(6 if g2 else 3)]
    S = tuple((planes[2 * i], planes[2 * i + 1]) for i in range(3)) if g2 else tuple(planes)
    want = finish_cuda.msm_finish_plain(ops, S)
    flat = lambda P: [c for x in P for c in (x if isinstance(x, tuple) else (x,))]  # noqa: E731
    name = "msm_finish_fp2" if g2 else "msm_finish_fp"
    before = kernels.LAUNCHES[name]
    got = finish_cuda.msm_finish_cuda(ops, S)
    assert kernels.LAUNCHES[name] == before + 2
    for g, w in zip(flat(got), flat(want)):
        assert g.shape == (R, spec.n, 1)
        assert torch.equal(g, w)
    with pytest.raises(ValueError):
        finish_cuda.msm_finish_cuda(ops, tuple(c[..., :3].contiguous() for c in flat(S)[:3]))


# the main path's shapes (BLS12-381 G1 at R = 4, G2 at R = 1, W = 64) and
# depth 32's lane count, NT = 8,192 (three tail stages)
@pytest.mark.parametrize("g2,W,R,NT", [(False, 64, 4, 1024), (True, 64, 1, 1024),
                                       (False, 64, 4, 8192), (True, 64, 1, 8192)],
                         ids=["g1", "g2", "g1_nt8192", "g2_nt8192"])
def test_msm_finish_kernel_matches_plain_at_the_proofs_shapes(g2, W, R, NT):
    _need_card()
    spec = fs.BLS_FQ
    ops = prove_lm.sw_ops(groth16.pairing_config("bls12_381"), g2, "cuda")
    planes = [_planes(spec, (W * R, spec.n, NT), 80 + i).reshape(W, R, spec.n, NT)
              for i in range(6 if g2 else 3)]
    S = tuple((planes[2 * i], planes[2 * i + 1]) for i in range(3)) if g2 else tuple(planes)
    want = finish_cuda.msm_finish_plain(ops, S)
    got = finish_cuda.msm_finish_cuda(ops, S)
    for g, w in zip(_flat(got), _flat(want)):
        assert g.shape == (R, spec.n, 1)
        assert torch.equal(g, w)


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_msm_finish_kernel_on_a_row_of_identities(g2):
    """Row 1's window sums are all the identity (0 : 1 : 0): the kernel
    equals the plain version, and row 1 comes out as the identity (Z = 0)."""
    _need_card()
    spec = fs.BLS_FQ
    W, R, NT = 5, 3, 64
    ops = prove_lm.sw_ops(groth16.pairing_config("bls12_381"), g2, "cuda")
    planes = [_planes(spec, (W * R, spec.n, NT), 90 + i).reshape(W, R, spec.n, NT)
              for i in range(6 if g2 else 3)]
    one = torch.as_tensor(fs.to_lm(spec.to_mont_host([1]))[:, 0].astype(np.int64),
                          dtype=torch.int32, device="cuda")
    for i, p in enumerate(planes):
        p[:, 1] = 0
        if i == (2 if g2 else 1):  # Y's (first) component: Montgomery 1
            p[:, 1] = one[:, None]
    S = tuple((planes[2 * i], planes[2 * i + 1]) for i in range(3)) if g2 else tuple(planes)
    want = finish_cuda.msm_finish_plain(ops, S)
    got = finish_cuda.msm_finish_cuda(ops, S)
    for g, w in zip(_flat(got), _flat(want)):
        assert torch.equal(g, w)
    Z = _flat(got)[4 if g2 else 2:]
    assert all(int(z[1].abs().sum()) == 0 for z in Z)


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_msm_finish_kernel_over_proof_rows(g2):
    """The batched MSM's finish: K1's (W, P, R, n, NT) window sums as the
    view (W, P R, n, NT) give, row for row, what P separate finishes give."""
    _need_card()
    spec = fs.BLS_FQ
    W, P, R, NT = 3, 3, 2, 512
    ops = prove_lm.sw_ops(groth16.pairing_config("bls12_381"), g2, "cuda")
    planes = [_planes(spec, (W * P * R, spec.n, NT), 40 + i).reshape(W, P, R, spec.n, NT)
              for i in range(6 if g2 else 3)]
    pack = (lambda ps: tuple((ps[2 * i], ps[2 * i + 1]) for i in range(3))) if g2 else tuple
    rows = finish_cuda.msm_finish_cuda(ops, pack([p.reshape(W, P * R, spec.n, NT) for p in planes]))
    for p in range(P):
        one = finish_cuda.msm_finish_cuda(ops, pack([c[:, p].contiguous() for c in planes]))
        for g, w in zip(_flat(rows), _flat(one)):
            assert torch.equal(g[p * R : (p + 1) * R], w)


def _finish_inputs(curve: str, g2: bool, W: int, R: int, NT: int, seed: int):
    spec = fs.BW6_FQ if curve == "bw6_761" else fs.BLS_FQ
    ops = prove_lm.sw_ops(groth16.pairing_config(curve), g2, "cuda")
    fp2 = g2 and curve == "bls12_381"
    planes = [_planes(spec, (W * R, spec.n, NT), seed + i).reshape(W, R, spec.n, NT)
              for i in range(6 if fp2 else 3)]
    S = tuple((planes[2 * i], planes[2 * i + 1]) for i in range(3)) if fp2 else tuple(planes)
    return ops, S


# rows on both sides of the kernel's kOwnRows (8: a join block an SM), and
# more join blocks than the card holds at once (600; at n = 48 two fit an SM)
@pytest.mark.parametrize("curve,g2,W,R,NT", [
    ("bls12_381", False, 4, 8, 1024), ("bls12_381", False, 4, 9, 1024),
    ("bls12_381", True, 4, 8, 256), ("bls12_381", True, 4, 9, 256),
    ("bw6_761", False, 3, 600, 64), ("bls12_381", True, 3, 600, 64)],
    ids=["g1_r8", "g1_r9", "g2_r8", "g2_r9", "bw6_r600", "g2_r600"])
def test_msm_finish_kernel_in_turn_and_beside_equal_plain(curve, g2, W, R, NT):
    """The join with the tail beside it (its programmatic dependent) and
    with the tail run to its end first give the plain version's planes."""
    _need_card()
    ops, S = _finish_inputs(curve, g2, W, R, NT, 110)
    want = _flat(finish_cuda.msm_finish_plain(ops, S))
    for run in (finish_cuda.msm_finish_cuda, finish_cuda.msm_finish_in_turn):
        for g, w in zip(_flat(run(ops, S)), want):
            assert torch.equal(g, w)


_SERIAL = """
import sys
import torch
from zkmember_tpu_torch.msm import finish_cuda
sys.path.insert(0, "tests")
import test_torch_cuda as t
for curve, g2, W, R, NT in [("bls12_381", False, 8, 4, 1024), ("bls12_381", True, 8, 1, 1024),
                            ("bw6_761", False, 3, 4, 512)]:
    ops, S = t._finish_inputs(curve, g2, W, R, NT, 120)
    got, want = finish_cuda.msm_finish_cuda(ops, S), finish_cuda.msm_finish_plain(ops, S)
    assert all(torch.equal(g, w) for g, w in zip(t._flat(got), t._flat(want))), (curve, g2)
print("equal")
"""


def test_msm_finish_kernel_with_launches_serialised():
    """CUDA_LAUNCH_BLOCKING=1 (a subprocess): the tail cannot start before
    the join ends, so the join does the tail's work itself; the output
    equals the plain version's."""
    _need_card()
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "CUDA_LAUNCH_BLOCKING": "1"}
    out = subprocess.run([sys.executable, "-c", _SERIAL], cwd=root, env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip().endswith("equal")


def _bw6_table(g2: bool, rows: int, B: int):
    """BW6-761 G1 (b3 = -3) or G2 (b3 = 12) ops and a K1 table of R rows of
    B distinct points (Fp at n = 48 for both groups)."""
    from zkmember_tpu_torch.curves import bw6_761 as bw6

    curve, gen = (bw6.G2, bw6.G2_GEN) if g2 else (bw6.G1, bw6.G1_GEN)
    rng = random.Random(9 + g2)
    step = curve.mul(rng.randrange(1, bw6.R), gen)
    P = curve.mul(rng.randrange(1, bw6.R), gen)
    pts = []
    for _ in range(B):
        pts.append(P)
        P = curve.add(P, step)

    def dev(vals):
        return torch.as_tensor(fs.to_lm(fs.BW6_FQ.to_mont_host(vals)).astype(np.int64),
                               dtype=torch.int32, device="cuda")

    X, Y = dev([p[0].v for p in pts]), dev([p[1].v for p in pts])
    ops = prove_lm.sw_ops(groth16.pairing_config("bw6_761"), g2, "cuda")
    assert ops.b3 == (12 if g2 else -3)
    tabs = [straus.table_program(ops, torch.roll(X, 7 * r, -1), torch.roll(Y, 7 * r, -1))
            for r in range(rows)]
    return ops, torch.cat(tabs, 1).contiguous()


@pytest.mark.parametrize("P", [1, 4])
@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_select_reduce_kernel_bw6_matches_plain(g2, P):
    """K1 at n = 48 (BW6-761), the proof's 95 windows, digits (W, P, R, B):
    one launch equals the plain version limb for limb."""
    _need_card()
    W, rows, B = 95, 2, 1024
    ops, tab = _bw6_table(g2, rows, B)
    digits = torch.randint(0, 16, (W, P, rows, B), dtype=torch.int32, device="cuda")
    before = kernels.LAUNCHES["select_reduce_fp48"]
    got = k1.select_reduce(ops, tab, digits)
    assert kernels.LAUNCHES["select_reduce_fp48"] == before + 1
    want = k1.select_reduce_plain(ops, tab, digits)
    for g, w in zip(_flat(got), _flat(want)):
        assert g.shape == (W, P, rows, 48, B // 16)
        assert torch.equal(g, w)


@pytest.mark.parametrize("P", [1, 4])
@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_msm_finish_kernel_bw6_matches_plain(g2, P):
    """The finish at n = 48 over 95 windows (odd, not a power of two) and P R
    rows, NT = 512 (contiguous halvings, then even/odd rounds)."""
    _need_card()
    spec = fs.BW6_FQ
    W, R, NT = 95, 1 if g2 else 4, 512
    ops = prove_lm.sw_ops(groth16.pairing_config("bw6_761"), g2, "cuda")
    S = tuple(_planes(spec, (W * P * R, spec.n, NT), 60 + i).reshape(W, P * R, spec.n, NT)
              for i in range(3))
    want = finish_cuda.msm_finish_plain(ops, S)
    before = kernels.LAUNCHES["msm_finish_fp48"]
    got = finish_cuda.msm_finish_cuda(ops, S)
    assert kernels.LAUNCHES["msm_finish_fp48"] == before + 2
    for g, w in zip(got, want):
        assert g.shape == (P * R, spec.n, 1)
        assert torch.equal(g, w)


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_msm_finish_kernel_bw6_matches_plain_at_the_proofs_shapes(g2):
    """The BW6-761 proof's finish shapes: W = 95, NT = 2,048, R = 4 (G1)
    and 1 (G2)."""
    _need_card()
    spec = fs.BW6_FQ
    W, R, NT = 95, 1 if g2 else 4, 2048
    ops = prove_lm.sw_ops(groth16.pairing_config("bw6_761"), g2, "cuda")
    S = tuple(_planes(spec, (W * R, spec.n, NT), 70 + i).reshape(W, R, spec.n, NT)
              for i in range(3))
    want = finish_cuda.msm_finish_plain(ops, S)
    got = finish_cuda.msm_finish_cuda(ops, S)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_kernel_wrappers_raise_on_an_unsupported_n():
    """K1 and the finish over a field of n = 16 limbs (BLS12-381 Fr) on CUDA
    tensors: ValueError, nothing launched, no plain fallback."""
    _need_card()
    from zkmember_tpu_torch.curves import device as cdv
    from zkmember_tpu_torch.fields import lm

    ops = cdv.SWOps(lm.FpOpsLM(fs.BLS_FR, "cuda"), 3, "bls12_381_fr/lm")
    before = dict(kernels.LAUNCHES)
    records = torch.zeros((16, 1, 512, 24), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="n = 16"):
        k1.select_reduce(ops, records, torch.zeros((4, 1, 1, 512), dtype=torch.int32,
                                                   device="cuda"))
    planes = tuple(torch.zeros((4, 1, 16, 8), dtype=torch.int32, device="cuda") for _ in range(3))
    with pytest.raises(ValueError, match="n = 16"):
        finish_cuda.msm_finish(ops, planes)
    assert kernels.LAUNCHES == before


def test_kzg_multi_row_commit_matches_plain():
    """A batch of KZG commitments over an SRS table of several rows (64
    lanes each), one of them shifted across a row boundary: the card's (K3
    setup, K2 table, K1 and the finish over the rows) equal the plain
    versions' on the CPU from the same rng."""
    _need_card()
    from zkmember_tpu_torch.snark import kzg
    from zkmember_tpu_torch.utils import rng as frng

    pps = [kzg.setup(200, rng=frng.test_rng(), device=d) for d in ("cuda", "cpu")]
    for a, b in ((pps[0].powers.x, pps[1].powers.x), (pps[0].powers.y, pps[1].powers.y)):
        assert torch.equal(a.cpu(), b)
    rng = random.Random(12)
    polys = [([rng.randrange(bls.R) for _ in range(k)], bound)
             for k, bound in ((201, None), (70, 100), (3, None), (64, 63))]
    before = kernels.LAUNCHES["select_reduce_fp"]
    got = kzg.commit_many(pps[0], polys, 64)  # 4 rows of 64 lanes for 201 powers
    assert kernels.LAUNCHES["select_reduce_fp"] == before + 1
    want = kzg.commit_many(pps[1], polys, 64)
    assert [(c.c, c.shifted) for c in got] == [(c.c, c.shifted) for c in want]
    assert all(c.c is not None for c in got)


def test_marlin_toy_proof_on_the_card_equals_the_plain_one():
    """The toy circuit of tests/test_marlin.py through universal setup,
    index and prove on the card (SRS of degree 192: one table row of 256
    lanes) and on the CPU (plain versions) from the same rng: the same
    index commitments and the same proof, which verifies; a wrong public
    input does not."""
    _need_card()
    from zkmember_tpu_torch.r1cs import gadgets as g
    from zkmember_tpu_torch.r1cs.cs import ConstraintSystem
    from zkmember_tpu_torch.snark import marlin
    from zkmember_tpu_torch.utils import rng as frng

    cs = ConstraintSystem(bls.Fr)
    out_val = (7 + 1) ** 2 * 7 % bls.R
    out = g.FpVar.new_input(cs, out_val)
    w = g.FpVar.new_witness(cs, 7)
    w1 = w.add_constant(1)
    (w1 * w1 * w).enforce_equal(out, "out")
    results = []
    for device in ("cuda", "cpu"):
        rng = frng.test_rng()
        pp = marlin.universal_setup(cs.num_constraints, cs.num_variables, 32, rng=rng,
                                    device=device)
        ipk, ivk = marlin.index(pp, cs, device=device)
        before = dict(kernels.LAUNCHES)
        proof = marlin.prove(ipk, cs, rng=rng, device=device)
        launched = {k: v - before[k] for k, v in kernels.LAUNCHES.items() if v != before[k]}
        results.append((ivk, proof, launched))
    (ivk, proof, launched), (ivk_cpu, proof_cpu, launched_cpu) = results
    assert launched == {"select_reduce_fp": 4, "msm_finish_fp": 8} and launched_cpu == {}
    for name in marlin.MATRICES:
        assert [(c.c, c.shifted) for c in ivk.matrix_comms[name]] == \
            [(c.c, c.shifted) for c in ivk_cpu.matrix_comms[name]]
    parts = [([(c.c, c.shifted) for c in p.comms1 + p.comms2 + p.comms3], p.sigma3,
              p.evals_beta1, p.evals_beta2, p.proof_beta1.w, p.proof_beta2.w)
             for p in (proof, proof_cpu)]
    assert parts[0] == parts[1]
    assert marlin.verify(ivk, [out_val], proof)
    assert not marlin.verify(ivk, [(out_val + 1) % bls.R], proof)


def test_device_merkle_tree_on_the_card_equals_the_cpu_one():
    """A 64-leaf pedersen381 tree hashed on the card (every product on K3)
    equals the same tree hashed on the CPU (plain K3), level for level, and
    the card's hash launched K3."""
    _need_card()
    from zkmember_tpu_torch.app import circuits as app
    from zkmember_tpu_torch.merkle import tree
    from zkmember_tpu_torch.utils import rng as frng

    leaf, node = app.get_config("pedersen381").setup_params(frng.test_rng())
    rng = np.random.default_rng(5)
    leaves = [bytes(rng.integers(0, 256, size=32, dtype=np.uint8)) for _ in range(64)]
    before = kernels.LAUNCHES["mont_mul_bm"]
    card = tree.MerkleTree(leaf, node, leaves, backend="device", device="cuda")
    assert kernels.LAUNCHES["mont_mul_bm"] > before
    cpu = tree.MerkleTree(leaf, node, leaves, backend="device", device="cpu")
    assert len(card.levels) == len(cpu.levels) == 7
    for a, b in zip(card.levels, cpu.levels):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _affine_planes(g2: bool, B: int, seed: int, device: str):
    """B distinct BLS12-381 G1 or G2 points as limb-major affine planes."""
    rng = random.Random(seed)
    curve, gen = (bls.G2, bls.G2_GEN) if g2 else (bls.G1, bls.G1_GEN)
    P, step = curve.mul(rng.randrange(1, bls.R), gen), curve.mul(rng.randrange(1, bls.R), gen)
    pts = []
    for _ in range(B):
        pts.append(P)
        P = curve.add(P, step)

    def dev(vals):
        return torch.as_tensor(fs.to_lm(fs.BLS_FQ.to_mont_host(vals)).astype(np.int64),
                               dtype=torch.int32, device=device)

    if g2:
        return (tuple(dev([p[0].coeffs[i].v for p in pts]) for i in range(2)),
                tuple(dev([p[1].coeffs[i].v for p in pts]) for i in range(2)))
    return dev([p[0].v for p in pts]), dev([p[1].v for p in pts])


def _cpu(c):
    return straus._map_coord(lambda t: t.cpu(), c)


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_on_the_fly_msm_on_the_card_equals_plain_and_the_table_route(g2):
    """window_sums and msm_program_chunked (1,024 lanes in 4 slices) on the
    card equal their plain versions on the CPU limb for limb, and the table
    route's MSM as points; each slice launches K1 once and the finish
    twice."""
    _need_card()
    B, W = 1024, 64
    X, Y = _affine_planes(g2, B, 30 + g2, "cuda")
    z = torch.as_tensor(fs.to_lm(fs.ints_to_limbs(
        [random.Random(40 + g2).randrange(bls.R) for _ in range(B)], 16)).astype(np.int64),
        dtype=torch.int32, device="cuda")
    ops = prove_lm.sw_ops(groth16.pairing_config("bls12_381"), g2, "cuda")
    cpu_ops = prove_lm.sw_ops(groth16.pairing_config("bls12_381"), g2, "cpu")
    S = straus.window_sums(ops, X, Y, z, W)
    S_cpu = straus.window_sums(cpu_ops, _cpu(X), _cpu(Y), z.cpu(), W)
    for g, w in zip(_flat(S), _flat(S_cpu)):
        assert g.shape == (W, 24, 1) and torch.equal(g.cpu(), w)
    k1_name = "select_reduce_fp2" if g2 else "select_reduce_fp"
    fin_name = "msm_finish_fp2" if g2 else "msm_finish_fp"
    before = dict(kernels.LAUNCHES)
    got = straus.msm_program_chunked(ops, X, Y, z, W, max_lanes=256)
    assert kernels.LAUNCHES[k1_name] == before[k1_name] + 4
    assert kernels.LAUNCHES[fin_name] == before[fin_name] + 8
    want = straus.msm_program_chunked(cpu_ops, _cpu(X), _cpu(Y), z.cpu(), W, max_lanes=256)
    for g, w in zip(_flat(got), _flat(want)):
        assert torch.equal(g.cpu(), w)
    curve = bls.G2 if g2 else bls.G1
    table = straus.msm_precomp_program(ops, straus.table_program(ops, X, Y), W, z)
    joined = straus.horner_join(ops, S)
    pts = [straus.projective_to_host(curve, _cpu(P)) for P in (got, table, joined)]
    assert pts[0] is not None and pts[0] == pts[1] == pts[2]


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_bool_msm_on_the_card_equals_plain(g2):
    """The masked lane reduction on the card (K2 only) equals its plain
    version on the CPU limb for limb, over 3 rows of 512 lanes on G1."""
    _need_card()
    B = 512
    X, Y = _affine_planes(g2, B, 50 + g2, "cuda")
    rows = 1 if g2 else 3
    if not g2:
        X, Y = (torch.stack([torch.roll(c, 5 * r, -1) for r in range(rows)]) for c in (X, Y))
    mask = torch.randint(0, 2, (rows, B) if not g2 else (B,), dtype=torch.int32, device="cuda")
    ops = prove_lm.sw_ops(groth16.pairing_config("bls12_381"), g2, "cuda")
    cpu_ops = prove_lm.sw_ops(groth16.pairing_config("bls12_381"), g2, "cpu")
    before = dict(kernels.LAUNCHES)
    got = straus.bool_msm_program(ops, X, Y, mask)
    launched = {k for k, v in kernels.LAUNCHES.items() if v != before[k]}
    assert launched == {"mont_mul"}
    want = straus.bool_msm_program(cpu_ops, _cpu(X), _cpu(Y), mask.cpu())
    for g, w in zip(_flat(got), _flat(want)):
        assert torch.equal(g.cpu(), w)


def test_options_proof_on_the_card_equals_the_cpu_one():
    """The toy cube circuit with one boolean witness: a precompute=False,
    merge_bool=False key proves on the card as on the CPU (plain versions)
    from the same rng, equal to the card's table-route proof; it verifies
    and a wrong public input does not."""
    _need_card()
    from zkmember_tpu_torch.r1cs import gadgets as g
    from zkmember_tpu_torch.r1cs.cs import ConstraintSystem
    from zkmember_tpu_torch.utils import rng as frng

    cs = ConstraintSystem(bls.Fr)
    out_val = pow(8, 3, bls.R)
    out = g.FpVar.new_input(cs, out_val)
    w = g.FpVar.new_witness(cs, 8)
    (w * w * w).enforce_equal(out, "cube")
    b1 = g.Boolean.new_witness(cs, 1)
    b1.select(out, g.FpVar.constant(cs, 0)).enforce_equal(out, "sel")
    pk, vk = groth16.setup(cs, "bls12_381", frng.test_rng(), device="cpu")
    opts = dict(cs=cs, precompute=False, merge_bool=False)
    card = prove_lm.Groth16KeysLM(pk, "cuda", **opts)
    assert card.has_bool and card.g1_tab is None and card.g2_tab is None
    before = dict(kernels.LAUNCHES)
    proof = prove_lm.prove(card, cs, rng=frng.test_rng(7))
    launched = {k for k, v in kernels.LAUNCHES.items() if v != before[k]}
    assert launched == {"mont_mul", "select_reduce_fp", "select_reduce_fp2", "msm_finish_fp",
                        "msm_finish_fp2"}
    cpu = prove_lm.prove(prove_lm.Groth16KeysLM(pk, "cpu", **opts), cs, rng=frng.test_rng(7))
    table = prove_lm.prove(prove_lm.Groth16KeysLM(pk, "cuda"), cs, rng=frng.test_rng(7))
    assert (proof.a, proof.b, proof.c) == (cpu.a, cpu.b, cpu.c) == (table.a, table.b, table.c)
    assert groth16.verify(vk, [out_val], proof)
    assert not groth16.verify(vk, [(out_val + 1) % bls.R], proof)


def test_kzg_past_the_budget_on_the_card_equals_the_table_route(monkeypatch):
    """kzg.setup(200) with a budget below D + 1: commitments run
    msm_program on the card in slices of 64 lanes (K1 once a slice, no
    SRS table) and equal the table route's."""
    _need_card()
    import dataclasses

    from zkmember_tpu_torch.snark import kzg
    from zkmember_tpu_torch.utils import rng as frng

    pp = kzg.setup(200, rng=frng.test_rng(), device="cuda")
    otf = dataclasses.replace(pp, max_tab_lanes=200)
    rng = random.Random(13)
    polys = [([rng.randrange(bls.R) for _ in range(k)], bound)
             for k, bound in ((201, None), (70, 100), (3, None))]
    monkeypatch.setattr(kzg, "MSM_CHUNK", 64)
    before = kernels.LAUNCHES["select_reduce_fp"]
    got = kzg.commit_many(otf, polys)  # 4 + 2 + 2 + 1 slices
    assert kernels.LAUNCHES["select_reduce_fp"] == before + 9 and otf.table is None
    want = kzg.commit_many(pp, polys)
    assert [(c.c, c.shifted) for c in got] == [(c.c, c.shifted) for c in want]


def test_table_budget_on_the_card_is_an_eighth_of_its_memory():
    """Keys and SRSs keep Straus tables within an eighth of the card's
    memory: a default SRS's lane budget is the powers whose table fits it."""
    _need_card()
    from zkmember_tpu_torch.snark import kzg
    from zkmember_tpu_torch.utils import rng as frng

    budget = straus.table_budget("cuda")
    assert budget == torch.cuda.get_device_properties(0).total_memory // 8
    pp = kzg.setup(8, rng=frng.test_rng(), device="cuda")
    ops = prove_lm.sw_ops(groth16.pairing_config("bls12_381"), False, "cuda")
    assert pp.max_tab_lanes == budget // straus.table_bytes(ops, 1, 1) and kzg.uses_table(pp)


# ---------------------------------------------------------------------------
# the sharded route (parallel.dist): the finish over D gathered lanes, the
# D-way combine in one process, a world of one rank over NCCL
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("NT", [1, 2, 4])
@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_msm_finish_kernel_over_d_lanes_matches_plain(g2, NT):
    """The finish at the sharded combine's widths, NT = D in {1, 2, 4}, on
    the proof's 64 windows, equals its plain version limb for limb."""
    _need_card()
    spec = fs.BLS_FQ
    W, R = 64, 1 if g2 else 4
    ops = prove_lm.sw_ops(groth16.pairing_config("bls12_381"), g2, "cuda")
    planes = [_planes(spec, (W * R, spec.n, NT), 90 + i).reshape(W, R, spec.n, NT)
              for i in range(6 if g2 else 3)]
    S = tuple((planes[2 * i], planes[2 * i + 1]) for i in range(3)) if g2 else tuple(planes)
    want = finish_cuda.msm_finish_plain(ops, S)
    got = finish_cuda.msm_finish_cuda(ops, S)
    for g, w in zip(_flat(got), _flat(want)):
        assert g.shape == (R, spec.n, 1)
        assert torch.equal(g, w)


@pytest.mark.parametrize("D", [2, 4, 8])
def test_sharded_combine_on_one_card_equals_the_unsharded_msm(D):
    """The local half (straus.sharded_window_sums) on each of D lane blocks
    of 2 rows of 4,096 G1 points, over the blocks of the whole table and
    over tables built on the fly from the blocks' points, stacked as the
    gather would (W, R, n, NT), then straus.combine_window_sums: equal limb
    for limb to msm_precomp_program over the whole table (the blocks are
    whole K1 tiles of 512 lanes) and, as points, to msm_program."""
    _need_card()
    from zkmember_tpu_torch.parallel import dist

    B, W = 4096, 64
    X, Y = _affine_planes(False, B, 60 + D, "cuda")
    X, Y = (torch.stack([c, torch.roll(c, 3, -1)]) for c in (X, Y))
    rng = random.Random(70 + D)
    z = torch.as_tensor(np.stack([fs.to_lm(fs.ints_to_limbs(
        [rng.randrange(bls.R) for _ in range(B)], 16)) for _ in range(2)]).astype(np.int64),
        dtype=torch.int32, device="cuda")
    ops = prove_lm.sw_ops(groth16.pairing_config("bls12_381"), False, "cuda")
    tab = straus.table_program(ops, X, Y)
    whole = straus.msm_precomp_program(ops, tab, W, z)
    want = [straus.projective_to_host(bls.G1, tuple(c[r].cpu() for c in
                                                    straus.msm_program(ops, X, Y, z, W)))
            for r in range(2)]
    for tabs in ([dist.block(tab, D, j, 2) for j in range(D)],
                 [straus.table_program(ops, *(dist.block(c, D, j, -1) for c in (X, Y)))
                  for j in range(D)]):
        S = [straus.sharded_window_sums(ops, t, dist.block(z, D, j, -1), W)
             for j, t in enumerate(tabs)]
        G = tuple(torch.cat([s[i] for s in S], dim=-1) for i in range(3))
        assert G[0].shape == (W, 2, 24, B // 16)
        before = kernels.LAUNCHES["msm_finish_fp"]
        got = straus.combine_window_sums(ops, G)
        assert kernels.LAUNCHES["msm_finish_fp"] == before + 2
        for g, w in zip(got, whole):
            assert torch.equal(g, w)
        for r in range(2):
            a = straus.projective_to_host(bls.G1, tuple(c[r].cpu() for c in got))
            assert a is not None and a == want[r]


def test_world_of_one_rank_over_nccl_equals_msm_program():
    """run_ranks with one rank on the card (NCCL: the gather is a real NCCL
    all-gather): sharded_msm_program over 2 rows of 512 G1 lanes equals
    msm_program as points on the fly, and msm_precomp_program limb for limb
    over the kept table."""
    _need_card()
    from torch_world import MESH, run_calls
    from zkmember_tpu_torch.parallel import dist

    B, W = 512, 64
    X, Y = _affine_planes(False, B, 80, "cuda")
    X, Y = (torch.stack([c, torch.roll(c, 5, -1)]) for c in (X, Y))
    rng = random.Random(81)
    z = torch.as_tensor(np.stack([fs.to_lm(fs.ints_to_limbs(
        [rng.randrange(bls.R) for _ in range(B)], 16)) for _ in range(2)]).astype(np.int64),
        dtype=torch.int32, device="cuda")
    ops = prove_lm.sw_ops(groth16.pairing_config("bls12_381"), False, "cuda")
    tab = straus.table_program(ops, X, Y)
    got, got_tab, backend = dist.run_ranks(run_calls, 1, device="cuda", args=([
        (straus.sharded_msm_program, 1, (ops, MESH, X, Y, z, W)),
        (straus.sharded_msm_program, 1, (ops, MESH, X, Y, z, W, tab)),
        (lambda: torch.distributed.get_backend(), 1, ()),
    ],))
    assert backend == "nccl"
    whole = straus.msm_program(ops, X, Y, z, W)
    for g, w in zip(got_tab, straus.msm_precomp_program(ops, tab, W, z)):
        assert torch.equal(g, w.cpu())
    for r in range(2):
        a, b = (straus.projective_to_host(bls.G1, tuple(c[r].cpu() for c in P))
                for P in (got, whole))
        assert a is not None and a == b


def test_run_ranks_refuses_more_ranks_than_cards():
    _need_card()
    from torch_world import run_calls
    from zkmember_tpu_torch.parallel import dist

    with pytest.raises(ValueError, match="a card a rank"):
        dist.run_ranks(run_calls, torch.cuda.device_count() + 1, device="cuda",
                       args=([],))
