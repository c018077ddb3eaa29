"""The port's Straus MSM path (kernel K1's plain version, tail reduction,
Horner join) against the JAX reference on G1.

Points and scalars come from a seeded random.Random; the JAX side runs the
reference's XLA composition (straus.window_sums / msm_program, the oracle
tests/test_pallas_msm.py holds the Pallas kernel against), and the host
curve gives an independent oracle.  Points are compared after
normalisation: the projective representative depends on the add order.
"""

import os
import random

import numpy as np
import pytest
import torch

from zkmember_tpu.curves import bls12_381 as jbls, device as jcdv
from zkmember_tpu.fields import device as dv, lm as jlm
from zkmember_tpu.msm import straus as jstraus
from zkmember_tpu_torch.curves import bls12_381 as bls
from zkmember_tpu_torch.fields import spec as fs
from zkmember_tpu_torch.msm import select_reduce_cuda as k1, straus
from zkmember_tpu_torch.snark import groth16, prove_lm


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int32))


def _case(seed, B, sbits):
    rng = random.Random(seed)
    pts = [bls.G1.mul(rng.randrange(1, bls.R), bls.G1_GEN) for _ in range(B)]
    scalars = [rng.randrange(1 << sbits) % bls.R for _ in range(B)]
    X = fs.to_lm(fs.BLS_FQ.to_mont_host([p[0].v for p in pts]))
    Y = fs.to_lm(fs.BLS_FQ.to_mont_host([p[1].v for p in pts]))
    z = fs.to_lm(fs.ints_to_limbs(scalars, 16))
    return pts, scalars, np.ascontiguousarray(X), np.ascontiguousarray(Y), np.ascontiguousarray(z)


def _host_msm(pts, scalars):
    acc = None
    for s, p in zip(scalars, pts):
        acc = bls.G1.add(acc, bls.G1.mul(s, p))
    return acc


def _ints(pt):
    return None if pt is None else (int(pt[0].v), int(pt[1].v))


def _ops():
    return prove_lm.sw_ops(groth16.pairing_config("bls12_381"), False, "cpu")


def _np(P):
    return tuple(c.numpy() for c in P)


def test_msm_g1_matches_reference_windows_and_total():
    nwin, B = 8, 16
    pts, scalars, X, Y, z = _case(11, B, 32)
    ops = _ops()
    tab = straus.table_program(ops, _t(X), _t(Y))
    digits = straus.digits_from_limbs(_t(z), nwin).contiguous()[:, None]
    S = k1.select_reduce_plain(ops, tab, digits)
    S = straus.tree_reduce_lanes(ops, tuple(c[:, 0] for c in S))  # (W, n, 1)

    jops = jcdv.sw_ops_for(jlm.FpOpsLM(dv.BLS_FQ), 12, "bls12_381_g1/lm")
    want_S = jstraus.window_sums(jops, X, Y, z, nwin)  # (W, n, 1) MSW first
    for w in range(nwin):
        got_w = straus.projective_to_host(bls.G1, tuple(c[w].numpy() for c in S))
        want_w = jstraus.projective_to_host(None, jbls.G1, tuple(np.asarray(c[w]) for c in want_S))
        assert _ints(got_w) == _ints(want_w), w

    got = straus.projective_to_host(bls.G1, _np(straus.horner_join(ops, S)))
    want = jstraus.projective_to_host(None, jbls.G1, jstraus.msm_program(jops, X, Y, z, nwin))
    assert _ints(got) == _ints(want) == _ints(_host_msm(pts, scalars))


def test_select_reduce_plain_tiles_in_kernel_order():
    """B = 1024 splits into 2 tiles of 32 threads x 16 lanes: output lane
    32 t + j of every window equals the host sum of the selected multiples
    of lanes 512 t + 32 k + j, k < 16 (the kernel's per-thread sum)."""
    nwin, B = 2, 1024
    rng = random.Random(12)
    step = bls.G1.mul(rng.randrange(1, bls.R), bls.G1_GEN)
    pts = [bls.G1.mul(rng.randrange(1, bls.R), bls.G1_GEN)]
    for _ in range(B - 1):
        pts.append(bls.G1.add(pts[-1], step))
    scalars = [rng.randrange(1 << 8) for _ in range(B)]
    X = fs.to_lm(fs.BLS_FQ.to_mont_host([p[0].v for p in pts]))
    Y = fs.to_lm(fs.BLS_FQ.to_mont_host([p[1].v for p in pts]))
    z = fs.to_lm(fs.ints_to_limbs(scalars, 16))
    assert k1.tile_shape(B) == (32, 16)
    ops = _ops()
    tab = straus.table_program(ops, _t(X), _t(Y))
    digits = straus.digits_from_limbs(_t(z), nwin).contiguous()[:, None]
    S = k1.select_reduce_plain(ops, tab, digits)
    assert S[0].shape == (nwin, 1, 24, 64)
    for w in range(nwin):
        shift = 4 * (nwin - 1 - w)
        for t in range(2):
            for j in range(32):
                want = None
                for k in range(16):
                    i = 512 * t + 32 * k + j
                    d = (scalars[i] >> shift) & 15
                    want = bls.G1.add(want, bls.G1.mul(d, pts[i]) if d else None)
                o = 32 * t + j
                got = straus.projective_to_host(
                    bls.G1, tuple(c[w, 0, :, o : o + 1].numpy() for c in S))
                assert _ints(got) == _ints(want), (w, t, j)


@pytest.mark.skipif(
    not os.environ.get("RUN_SLOW"),
    reason="the reference's interpret-mode Pallas MSM takes minutes on the CPU; RUN_SLOW=1",
)
def test_msm_g1_matches_reference_precomp_interpret():
    nwin, B = 8, 16
    pts, scalars, X, Y, z = _case(11, B, 32)
    ops = _ops()
    tab = straus.table_program(ops, _t(X), _t(Y))
    got = straus.projective_to_host(bls.G1, _np(straus.msm_precomp_program(ops, tab, nwin, _t(z))))
    jops = jcdv.sw_ops_for(jlm.FpOpsLM(dv.BLS_FQ), 12, "bls12_381_g1/lm")
    jtab = jstraus.table_program(jops, X, Y)
    want = jstraus.projective_to_host(
        None, jbls.G1, jstraus.msm_precomp_program(jops, jtab, nwin, z))
    assert _ints(got) == _ints(want)


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_pack_records_layout(g2):
    """The K1 kernel's packed table: entry e of lane i of row r is one
    record of 32-bit words lo | hi << 16, coordinates X, Y, Z, each in its
    components' order; a table without a row axis gets R = 1; unpacking
    gives the planes back."""
    rng = np.random.default_rng(3)
    R, B = 2, 8
    comps = 2 if g2 else 1
    planes = [torch.from_numpy(rng.integers(0, 1 << 16, size=(16, R, 24, B)).astype(np.int32))
              for _ in range(3 * comps)]
    tab = tuple((planes[2 * c], planes[2 * c + 1]) for c in range(3)) if g2 else tuple(planes)
    rec = k1.pack_records(tab)
    assert rec.shape == (16, R, B, 3 * comps * 12) and rec.is_contiguous()
    for e, r, i in ((0, 0, 0), (5, 1, 3), (15, 1, 7)):
        want = [int(p[e, r, 2 * w, i]) | int(p[e, r, 2 * w + 1, i]) << 16
                for p in planes for w in range(12)]
        assert [int(v) & 0xFFFFFFFF for v in rec[e, r, i]] == want
    lifted = k1.pack_records(straus._map_coord(lambda c: c[:, 0], tab))
    assert torch.equal(lifted, rec[:, :1])
    back = k1.unpack_records(rec, g2)
    flat = [c for x in back for c in (x if g2 else (x,))]
    assert all(torch.equal(b, p) for b, p in zip(flat, planes)) and len(flat) == len(planes)
