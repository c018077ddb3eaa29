"""The port's sharded Straus and boolean MSMs (straus.sharded_msm_program,
sharded_bool_msm_program) against the JAX package's.

One 4-rank gloo world (tests/torch_world.py) runs every case over the
port's meshes, (1, 4) for D = 4 and (2, 2) for D = 2; the JAX side runs the
reference's programs meanwhile over zkmember_tpu.parallel.dist meshes of
the conftest's virtual CPU devices.  Cases: G1 rows at 64 lanes a rank
and at blocks of 16 and 32 lanes (padded to K1's 64 with zero scalars),
G2 at 64 lanes a rank, each with the table built on the fly and, for G1
at 64 and 16 lanes a rank and G2, over the blocks of a kept table (built
here, passed to every rank); and the boolean class for G1 rows and G2.
Points and scalars come from seeded random.Random; both results are
compared as points (normalised) and with a host MSM.  Then the combine
(the finish) over D = 1, 2, 4 and 8 gathered lanes: equal to the
reference's tree_reduce_lanes and horner_join on the same window sums.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkmember_tpu.curves import bls12_381 as jbls, device as jcdv
from zkmember_tpu.fields import device as jdv, lm as jlm
from zkmember_tpu.msm import straus as jstraus
from zkmember_tpu.parallel import dist as jdist
from zkmember_tpu_torch.curves import bls12_381 as bls
from zkmember_tpu_torch.fields import spec as fs
from zkmember_tpu_torch.msm import straus
from zkmember_tpu_torch.snark import groth16, prove_lm
from torch_world import MESH, World

RANKS = 4
NWIN = 8  # 32-bit scalars
# (name, g2, D, dp, rows, lanes, boolean, kept table)
CASES = [
    ("g1_64_a_rank", False, 4, 1, 2, 256, False, False),
    ("g1_16_a_rank", False, 4, 1, 2, 64, False, False),
    ("g1_32_a_rank_d2", False, 2, 2, 2, 64, False, False),
    ("g2_64_a_rank_d2", True, 2, 2, 0, 128, False, False),
    ("g1_bool_d4", False, 4, 1, 3, 64, True, False),
    ("g2_bool_d2", True, 2, 2, 0, 32, True, False),
    ("g1_64_a_rank_table", False, 4, 1, 2, 256, False, True),
    ("g1_16_a_rank_table", False, 4, 1, 2, 64, False, True),
    ("g2_64_a_rank_d2_table", True, 2, 2, 0, 128, False, True),
]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _points(curve, gen, count, rng):
    """count distinct points P_0 = a G, P_i = P_(i-1) + b G (cheap on the host)."""
    P, step = curve.mul(rng.randrange(1, bls.R), gen), curve.mul(rng.randrange(1, bls.R), gen)
    out = []
    for _ in range(count):
        out.append(P)
        P = curve.add(P, step)
    return out


def _plane(vals):
    return np.ascontiguousarray(fs.to_lm(fs.BLS_FQ.to_mont_host(vals)))


def _case(g2, rows, lanes, boolean, seed):
    """Host points and scalars, and the planes: X, Y ([R,] n, B) (pairs for
    G2), scalar limbs ([R,] 16, B) or a mask ([R,] B)."""
    rng = random.Random(seed)
    curve, gen = (bls.G2, bls.G2_GEN) if g2 else (bls.G1, bls.G1_GEN)
    R = max(rows, 1)
    pts = [_points(curve, gen, lanes, rng) for _ in range(R)]
    if boolean:
        scal = [[rng.randrange(2) for _ in range(lanes)] for _ in range(R)]
    else:
        scal = [[rng.randrange(1 << 32) if rng.random() > 0.1 else 0 for _ in range(lanes)]
                for _ in range(R)]

    def coord(i):
        if g2:
            return tuple(np.stack([_plane([p[i].coeffs[j].v for p in row]) for row in pts])
                         for j in range(2))
        return np.stack([_plane([p[i].v for p in row]) for row in pts])

    X, Y = coord(0), coord(1)
    if boolean:
        z = np.asarray(scal, np.uint32)
    else:
        z = np.stack([fs.to_lm(fs.ints_to_limbs(r, 16)) for r in scal]).astype(np.uint32)
    if not rows:  # no row axis
        X, Y, z = (straus._map_coord(lambda c: c[0], c) for c in (X, Y, z))
    return pts, scal, X, Y, z


INPUTS = {c[0]: _case(*c[1:2], *c[4:7], seed=i) for i, c in enumerate(CASES)}
CFG = groth16.pairing_config("bls12_381")


def _t(c):
    if isinstance(c, tuple):
        return tuple(_t(x) for x in c)
    return torch.as_tensor(np.asarray(c).astype(np.int64), dtype=torch.int32)


def _j(c):
    if isinstance(c, tuple):
        return tuple(_j(x) for x in c)
    return jnp.asarray(c)


def _port_calls():
    calls = []
    for name, g2, D, dp, rows, lanes, boolean, table in CASES:
        _, _, X, Y, z = INPUTS[name]
        ops = prove_lm.sw_ops(CFG, g2, "cpu")
        if boolean:
            calls.append((straus.sharded_bool_msm_program, dp, (ops, MESH, _t(X), _t(Y),
                                                                 _t(z))))
        else:
            tab = straus.table_program(ops, _t(X), _t(Y)) if table else None
            calls.append((straus.sharded_msm_program, dp, (ops, MESH, _t(X), _t(Y), _t(z),
                                                           NWIN, tab)))
    return calls


@pytest.fixture(scope="module")
def world():
    return World(RANKS, _port_calls())


def _jops(g2):
    if g2:
        return jcdv.sw_ops_for(jlm.Fp2OpsLM(jdv.BLS_FQ2), (12, 12), "bls12_381_g2/lm")
    return jcdv.sw_ops_for(jlm.FpOpsLM(jdv.BLS_FQ), 12, "bls12_381_g1/lm")


@pytest.fixture(scope="module")
def reference(world):
    """The JAX package's sharded programs, run while the port's world runs."""
    out = {}
    for name, g2, D, dp, rows, lanes, boolean, _ in CASES:
        _, _, X, Y, z = INPUTS[name]
        mesh = jdist.make_mesh(RANKS, dp=dp)
        if boolean:
            r = jstraus.sharded_bool_msm_program(_jops(g2), mesh, _j(X), _j(Y), _j(z))
        else:
            r = jstraus.sharded_msm_program(_jops(g2), mesh, _j(X), _j(Y), _j(z), NWIN)
        out[name] = jax.tree.map(np.asarray, r)
    return out


def _np(c):
    if isinstance(c, tuple):
        return tuple(_np(x) for x in c)
    return c.numpy() if isinstance(c, torch.Tensor) else np.asarray(c)


def _ints(pt):
    if pt is None:
        return None

    def c(v):
        return tuple(int(x.v) for x in v.coeffs) if hasattr(v, "coeffs") else int(v.v)

    return (c(pt[0]), c(pt[1]))


def _rows(P, rows):
    """Projective coords ([R,] n, 1) -> one point per row."""
    if not rows:
        return [P]
    return [tuple(straus._map_coord(lambda c: c[r], x) for x in P) for r in range(rows)]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_sharded_msm_program_matches_jax_and_host(world, reference, case):
    name, g2, D, dp, rows, lanes, boolean, _ = case
    pts, scal, *_ = INPUTS[name]
    got = world.result([c[0] for c in CASES].index(name))
    assert straus._lanes(got[0]) == 1
    curve, jcurve = (bls.G2, jbls.G2) if g2 else (bls.G1, jbls.G1)
    for r, (P, JP) in enumerate(zip(_rows(_np(got), rows), _rows(reference[name], rows))):
        want = None
        for s, q in zip(scal[r], pts[r]):
            want = curve.add(want, curve.mul(s, q))
        assert _ints(straus.projective_to_host(curve, P)) == _ints(want), r
        assert _ints(jstraus.projective_to_host(None, jcurve, JP)) == _ints(want), r


@pytest.mark.parametrize("D", [1, 2, 4, 8])
def test_combine_over_d_lanes_matches_the_reference(D):
    """The combine of the sharded route over D gathered lanes equals the
    reference's tree_reduce_lanes plus horner_join of the same window sums,
    as points; its input is (W, R, n, D), its output (R, n, 1)."""
    rng = random.Random(40 + D)
    W, R = 3, 2
    pts = _points(bls.G1, bls.G1_GEN, W * R * D, rng)
    X = np.stack([_plane([p[0].v for p in pts[i * D:(i + 1) * D]]) for i in range(W * R)])
    Y = np.stack([_plane([p[1].v for p in pts[i * D:(i + 1) * D]]) for i in range(W * R)])
    one = np.broadcast_to(np.asarray(fs.BLS_FQ.one_mont)[:, None], X.shape[1:])
    S = tuple(c.reshape(W, R, fs.BLS_FQ.n, D) for c in (X, Y, np.stack([one] * (W * R))))
    got = straus.combine_window_sums(prove_lm.sw_ops(CFG, False, "cpu"), _t(S))
    jops = _jops(False)
    want = jstraus.horner_join(jops, jstraus.tree_reduce_lanes(jops, _j(S)))
    for r in range(R):
        a = straus.projective_to_host(bls.G1, tuple(_np(c)[r] for c in got))
        b = jstraus.projective_to_host(None, jbls.G1, tuple(np.asarray(c)[r] for c in want))
        assert _ints(a) == _ints(b) is not None
