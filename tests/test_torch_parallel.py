"""The port's multi-device layer (parallel.dist) against the JAX package's.

The port's side runs in ONE 4-rank gloo world (``dist.run_ranks`` with
``device="cpu"``: spawned processes, rendezvous on 127.0.0.1), started in
a background thread when the module's first test asks for it
(tests/torch_world.py): each call
of ``run_calls`` builds its (dp, msm) mesh over that world,
(2, 2) for D = 2 and (1, 4) for D = 4, and rank 0's results come back.
The JAX side runs meanwhile on the conftest's virtual CPU devices, over
``zkmember_tpu.parallel.dist.make_mesh(4, dp)`` with the same inputs,
made from seeded random.Random.  Field results must match limb for limb,
MSMs as points (after normalisation; both are also held against a host
MSM).  Then the launcher's refusals and the mesh's checks.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkmember_tpu.app import circuits as japp
from zkmember_tpu.fields import device as jdv
from zkmember_tpu.msm import msm as jmsm
from zkmember_tpu.parallel import dist as jdist
from zkmember_tpu.utils import rng as jrng
from zkmember_tpu_torch import entry
from zkmember_tpu_torch.curves import bls12_381 as bls
from zkmember_tpu_torch.fields import device as dv
from zkmember_tpu_torch.fields import spec as fs
from zkmember_tpu_torch.msm import msm, straus
from zkmember_tpu_torch.parallel import dist
from torch_world import MESH, World, run_calls

RANKS = 4
DPS = {2: 2, 4: 1}  # D (the msm axis) -> dp: meshes (2, 2) and (1, 4)
NBITS = 64  # scalar bits of the Jacobian MSM (a double-and-add per bit)
K = 8  # its points
N_NTT = 256
B_HASH = 8
B_SUM = 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _inputs():
    rng = random.Random(21)
    pts = [bls.G1.mul(rng.randrange(1, bls.R), bls.G1_GEN) for _ in range(K)]
    scalars = [rng.randrange(1 << NBITS) for _ in range(K)]
    spec = fs.BLS_FR
    return {
        "pts": pts, "scalars": scalars,
        "X": fs.BLS_FQ.to_mont_host([p[0].v for p in pts]),
        "Y": fs.BLS_FQ.to_mont_host([p[1].v for p in pts]),
        "bits": msm.scalars_to_bits_np(scalars, NBITS),
        "sum": [rng.randrange(spec.p) for _ in range(B_SUM)],
        "ntt": [rng.randrange(spec.p) for _ in range(N_NTT)],
        "left": [rng.randrange(spec.p) for _ in range(B_HASH)],
        "right": [rng.randrange(spec.p) for _ in range(B_HASH)],
    }


INPUTS = _inputs()


def _t(a):
    return torch.as_tensor(np.asarray(a).astype(np.int64), dtype=torch.int32)


def _port_calls():
    d = INPUTS
    F = dv.FpOps(fs.BLS_FQ, "cpu")
    spec = fs.BLS_FR
    calls = []
    for D, dp in DPS.items():
        calls += [
            (dist.sharded_msm, dp, (F, MESH, d["bits"], _t(d["X"]), _t(d["Y"]))),
            (dist.sharded_field_sum, dp, (spec, MESH, _t(spec.to_mont_host(d["sum"])))),
            (dist.sharded_ntt, dp, (spec, MESH, _t(spec.to_mont_host(d["ntt"])))),
            (entry.sharded_hash, dp, (MESH, _t(fs.ints_to_limbs(d["left"], spec.n)),
                                      _t(fs.ints_to_limbs(d["right"], spec.n)))),
        ]
    return calls


WHAT = ["msm", "sum", "ntt", "hash"]


@pytest.fixture(scope="module")
def world():
    return World(RANKS, _port_calls())


def _result(world, D, what):
    return world.result(list(DPS).index(D) * len(WHAT) + WHAT.index(what))


@pytest.fixture(scope="module")
def reference(world):
    """The JAX package's results, computed while the port's world runs."""
    d = INPUTS
    spec = jdv.BLS_FR
    F = jdv.FpOps(jdv.BLS_FQ)
    _, node = japp.get_config("pedersen381").setup_params(jrng.test_rng())
    out = {}
    for D, dp in DPS.items():
        mesh = jdist.make_mesh(RANKS, dp=dp)
        out[D, "msm"] = jax.jit(lambda b, x, y: jdist.sharded_msm(F, mesh, b, x, y))(
            jnp.asarray(jmsm.scalars_to_bits_np(d["scalars"], NBITS)), jnp.asarray(d["X"]),
            jnp.asarray(d["Y"]))
        out[D, "sum"] = jax.jit(lambda v: jdist.sharded_field_sum(spec, mesh, v))(
            jnp.asarray(spec.to_mont_host(d["sum"])))
        out[D, "ntt"] = jax.jit(lambda v: jdist.sharded_ntt(spec, mesh, v))(
            jnp.asarray(spec.to_mont_host(d["ntt"])))
        out[D, "hash"] = jax.jit(lambda a, b: jdist.sharded_two_to_one(node, mesh, a, b))(
            jnp.asarray(jdv.ints_to_limbs(d["left"], spec.n)),
            jnp.asarray(jdv.ints_to_limbs(d["right"], spec.n)))
    return {k: jax.tree.map(np.asarray, v) for k, v in out.items()}


def _jacobian_to_host(J):
    """A Jacobian point of (1, n) Montgomery rows -> host affine ints or None."""
    p, rinv = fs.BLS_FQ.p, pow(fs.BLS_FQ.R, -1, fs.BLS_FQ.p)
    X, Y, Z = (fs.limbs_to_int(np.asarray(c)[0]) * rinv % p for c in J)
    if Z == 0:
        return None
    zi = pow(Z, -1, p)
    return (X * zi * zi % p, Y * zi * zi * zi % p)


@pytest.mark.parametrize("D", sorted(DPS))
def test_sharded_msm_matches_jax_and_host(world, reference, D):
    want = None
    for s, q in zip(INPUTS["scalars"], INPUTS["pts"]):
        want = bls.G1.add(want, bls.G1.mul(s, q))
    want = (want[0].v, want[1].v)
    got = _result(world, D, "msm")
    assert all(tuple(c.shape) == (1, fs.BLS_FQ.n) for c in got)
    assert _jacobian_to_host(got) == _jacobian_to_host(reference[D, "msm"]) == want


@pytest.mark.parametrize("D", sorted(DPS))
def test_sharded_field_sum_matches_jax(world, reference, D):
    got = _result(world, D, "sum")
    assert np.array_equal(got.numpy().astype(np.int64), reference[D, "sum"].astype(np.int64))
    spec = fs.BLS_FR
    assert spec.from_mont_host(got.numpy())[0] == sum(INPUTS["sum"]) % spec.p


@pytest.mark.parametrize("D", sorted(DPS))
def test_sharded_ntt_matches_jax(world, reference, D):
    got = _result(world, D, "ntt")
    assert tuple(got.shape) == (N_NTT, fs.BLS_FR.n)
    assert np.array_equal(got.numpy().astype(np.int64), reference[D, "ntt"].astype(np.int64))


@pytest.mark.parametrize("D", sorted(DPS))
def test_sharded_two_to_one_matches_jax(world, reference, D):
    got = _result(world, D, "hash")
    assert np.array_equal(got.numpy().astype(np.int64), reference[D, "hash"].astype(np.int64))


def test_run_ranks_raises_when_a_rank_raises():
    with pytest.raises(RuntimeError, match=r"(?s)rank \d of 2 failed.*ValueError.*dp = 3"):
        dist.run_ranks(run_calls, 2, device="cpu",
                       args=([(dist.make_mesh, 1, (None, 3, "cpu"))],))


@pytest.mark.parametrize("device", [None, "cuda"])
def test_run_ranks_refuses_cuda_without_a_card(device):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dist.run_ranks(run_calls, 1, device=device, args=([],))


def test_make_mesh_checks():
    with pytest.raises(RuntimeError, match="initialised process group"):
        dist.make_mesh(1, device="cpu")
    for args, msg in (((2, 1, "cpu"), "world of 1"), ((None, 3, "cpu"), "dp = 3")):
        with pytest.raises(ValueError, match=msg):
            dist.run_ranks(run_calls, 1, device="cpu", args=([(dist.make_mesh, 1, args)],))
    mesh = dist.run_ranks(run_calls, 1, device="cpu",
                          args=([(lambda m: (m.shape, m.coords, m.size), 1, (MESH,))],))[0]
    assert mesh == ({"dp": 1, "msm": 1}, {"dp": 0, "msm": 0}, 1)


def test_non_power_of_two_msm_axis_raises():
    mesh = dist.Mesh(shape={"dp": 1, "msm": 3}, coords={"dp": 0, "msm": 0},
                     device=torch.device("cpu"), groups={})
    ops = straus.cdv.SWOps(None, 12, "g1")
    X = torch.zeros(fs.BLS_FQ.n, 6, dtype=torch.int32)
    with pytest.raises(ValueError, match="power-of-two"):
        straus.sharded_msm_program(ops, mesh, X, X, X, 4)
    with pytest.raises(ValueError, match="power-of-two"):
        straus.sharded_bool_msm_program(ops, mesh, X, X, X[0])
    with pytest.raises(ValueError, match="power-of-two"):
        straus.combine_window_sums(ops, (X[None, :, :3],) * 3)
