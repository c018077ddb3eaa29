"""Entry points (counterparts of ``__graft_entry__.entry`` and ``dryrun_multichip``).

``entry(device)`` returns ``(fn, (left, right))``: one batched two-to-one
Pedersen Merkle-level hash (the reference's hot loop) of 8 node pairs on
the pedersen381 stack, its inputs made from ``np.random.default_rng(0)`` as
the reference makes them.  ``fn(left, right)`` returns canonical (8, 16)
int32 digest limbs on the inputs' device.

``dryrun_multi(n_ranks, device)`` runs one sharded proving step on n_ranks
ranks (``parallel.dist.run_ranks``: NCCL over n_ranks cards by default, gloo
over CPU processes with ``device="cpu"``): the batched hash on a (2, n/2)
mesh, the sharded Straus MSM against a host MSM, the field sum, the
four-step NTT against the single-device one, and the toy circuit's proof
with every MSM sharded, which must verify.  It raises on any failure.

Run: python -c "from zkmember_tpu_torch import entry; fn, args = entry.entry(); print(fn(*args))"
     python -c "from zkmember_tpu_torch import entry; print(entry.dryrun_multi(4, 'cpu'))"
"""

from __future__ import annotations

import functools
import random
import time

import numpy as np
import torch

from zkmember_tpu_torch import device as devices

BATCH = 8


@functools.lru_cache(maxsize=1)
def _params():
    from zkmember_tpu_torch.app import circuits as app
    from zkmember_tpu_torch.utils import rng as frng

    cfg = app.get_config("pedersen381")
    leaf_params, node_params = cfg.setup_params(frng.test_rng())
    return cfg, leaf_params, node_params


def entry(device=None):
    """(fn, example_args) on ``device.resolve(device)``: the card unless the
    caller passes "cpu"."""
    from zkmember_tpu_torch.fields import spec as fs
    from zkmember_tpu_torch.hash import pedersen as ph

    dev = devices.resolve(device)
    _, _, node_params = _params()
    n = node_params.spec.n

    def fn(left, right):
        return ph.two_to_one_device(node_params, left, right)

    rng = np.random.default_rng(0)

    def digests():
        limbs = fs.ints_to_limbs([int(rng.integers(1 << 62)) for _ in range(BATCH)], n)
        return torch.as_tensor(limbs.astype(np.int32), device=dev)

    left = digests()
    right = digests()
    return fn, (left, right)


def dryrun_multi(n_ranks: int, device=None) -> dict:
    """One sharded proving step over n_ranks ranks (a power of two: the
    Straus combine needs one on the msm axis); returns rank 0's report
    (world size, backend, seconds per step).  device: "cuda" (the default:
    NCCL, one card a rank) or "cpu" (gloo)."""
    from zkmember_tpu_torch.parallel import dist

    if n_ranks < 1 or n_ranks & (n_ranks - 1):
        raise ValueError(f"dryrun_multi needs a power-of-two rank count, got {n_ranks}")
    return dist.run_ranks(_dryrun_rank, n_ranks, device=device)


def sharded_hash(mesh, left, right):
    """``dist.sharded_two_to_one`` with the pedersen381 node parameters of
    ``entry`` (the dry run's first step)."""
    from zkmember_tpu_torch.parallel import dist

    return dist.sharded_two_to_one(_params()[2], mesh, left, right)


def toy_circuit():
    """The dry run's circuit (the reference's): out = w^3 for w = 8, plus a
    boolean select; returns (cs, out)."""
    from zkmember_tpu_torch.curves import bls12_381 as bls
    from zkmember_tpu_torch.r1cs import gadgets as g
    from zkmember_tpu_torch.r1cs.cs import ConstraintSystem

    cs = ConstraintSystem(bls.Fr)
    out_val = pow(8, 3, bls.R)
    out_v = g.FpVar.new_input(cs, out_val)
    w = g.FpVar.new_witness(cs, 8)
    (w * w * w).enforce_equal(out_v, "cube")
    b1 = g.Boolean.new_witness(cs, 1)
    b1.select(out_v, g.FpVar.constant(cs, 0)).enforce_equal(out_v, "sel")
    return cs, out_val


def toy_proof(mesh=None, merge_bool: bool = True, device=None) -> dict:
    """The toy circuit's Groth16 proof: keys from the host setup
    (``groth16.setup(..., host=True)`` with ``utils.rng.test_rng()``), the
    proof's r and s from the same rng after it, as the reference's dry run.
    With a mesh every MSM is sharded over its "msm" axis (the key built with
    min_lanes = its size and warmed by ``warm_sharded``); without one the
    proof runs on ``device`` (the card unless the caller passes "cpu").
    Returns the proof's points as ints and whether it verifies, and whether
    it verifies a wrong public input."""
    from zkmember_tpu_torch.curves import bls12_381 as bls
    from zkmember_tpu_torch.snark import groth16, prove_lm
    from zkmember_tpu_torch.utils import rng as frng

    cs, out_val = toy_circuit()
    rng = frng.test_rng()
    pk, vk = groth16.setup(cs, curve="bls12_381", rng=rng, host=True)
    dev = mesh.device if mesh is not None else devices.resolve(device)
    D = mesh.shape["msm"] if mesh is not None else 1
    keys = prove_lm.Groth16KeysLM(pk, dev, cs=cs, min_lanes=D, merge_bool=merge_bool)
    if mesh is not None:
        prove_lm.warm_sharded(keys, mesh)
    proof = prove_lm.prove(keys, cs, rng=rng, mesh=mesh)

    def ints(pt):
        def c(v):
            return tuple(int(x.v) for x in v.coeffs) if hasattr(v, "coeffs") else int(v.v)

        return (c(pt[0]), c(pt[1]))

    return {"a": ints(proof.a), "b": ints(proof.b), "c": ints(proof.c),
            "verifies": groth16.verify(vk, [out_val], proof),
            "wrong_input_verifies": groth16.verify(vk, [(out_val + 1) % bls.R], proof)}


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"dryrun_multi: {what}")


def _dryrun_rank(mesh) -> dict:
    """The dry run on one rank (``dist.run_ranks``' rank function)."""
    from zkmember_tpu_torch.curves import bls12_381 as bls
    from zkmember_tpu_torch.fields import spec as fs
    from zkmember_tpu_torch.hash import pedersen as ph
    from zkmember_tpu_torch.msm import straus
    from zkmember_tpu_torch.ntt import ntt as nttmod
    from zkmember_tpu_torch.parallel import dist
    from zkmember_tpu_torch.snark import groth16, prove_lm

    n, dev = mesh.size, mesh.device
    times: dict = {}
    t = time.perf_counter()

    def mark(name):
        nonlocal t
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        times[name] = now - t
        t = now

    spec = _params()[2].spec
    mesh_h = dist.make_mesh(dp=2 if n % 2 == 0 else 1, device=dev)
    mesh_m = dist.make_mesh(dp=1, device=dev)
    rng = random.Random(7)

    def tensor(arr):
        return torch.as_tensor(np.ascontiguousarray(arr).astype(np.int64), dtype=torch.int32,
                               device=dev)

    # 1) data-parallel hashing over both axes
    B = max(8, n)
    hl = tensor(fs.ints_to_limbs([rng.randrange(spec.p) for _ in range(B)], spec.n))
    hr = tensor(fs.ints_to_limbs([rng.randrange(spec.p) for _ in range(B)], spec.n))
    _check(torch.equal(sharded_hash(mesh_h, hl, hr), ph.two_to_one_device(_params()[2], hl, hr)),
           "sharded hashing disagrees with the unsharded batch")
    mark("hash_s")

    # 2) the sharded Straus MSM against a host MSM: points a G + i b G, so
    # the host MSM is one multiplication of G
    k = max(16, 2 * n)
    a, b = rng.randrange(1, bls.R), rng.randrange(1, bls.R)
    pt, step, pts = bls.G1.mul(a, bls.G1_GEN), bls.G1.mul(b, bls.G1_GEN), []
    for _ in range(k):
        pts.append(pt)
        pt = bls.G1.add(pt, step)
    scalars = [rng.randrange(bls.R) for _ in range(k)]
    X = tensor(fs.to_lm(fs.BLS_FQ.to_mont_host([p[0].v for p in pts])))
    Y = tensor(fs.to_lm(fs.BLS_FQ.to_mont_host([p[1].v for p in pts])))
    z = tensor(fs.to_lm(fs.ints_to_limbs(scalars, fs.BLS_FR.n)))
    ops1 = prove_lm.sw_ops(groth16.pairing_config("bls12_381"), False, dev)
    nwin = (bls.R.bit_length() + straus.WINDOW_BITS - 1) // straus.WINDOW_BITS
    out = straus.sharded_msm_program(ops1, mesh_m, X, Y, z, nwin)
    want = bls.G1.mul(sum(s_ * (a + i * b) for i, s_ in enumerate(scalars)) % bls.R,
                      bls.G1_GEN)
    _check(straus.projective_to_host(bls.G1, tuple(c.cpu() for c in out)) == want,
           "sharded MSM disagrees with the host MSM")
    mark("msm_s")

    # 3) the field sum: an int64 all-reduce of limb columns
    vals = [rng.randrange(spec.p) for _ in range(2 * mesh_h.shape["msm"])]
    got = dist.sharded_field_sum(spec, mesh_h, tensor(spec.to_mont_host(vals)), max_log_terms=4)
    _check(spec.from_mont_host(got.cpu().numpy())[0] == sum(vals) % spec.p,
           "sharded field sum disagrees with the integers")
    mark("field_sum_s")

    # 4) the four-step NTT over every rank
    fr = fs.BLS_FR
    N = max(64, n * n)
    coeffs = tensor(fr.to_mont_host([rng.randrange(fr.p) for _ in range(N)]))
    _check(torch.equal(dist.sharded_ntt(fr, mesh_m, coeffs),
                       nttmod.ntt(nttmod.Domain.get(fr, N), coeffs)),
           "sharded NTT disagrees with the single-device NTT")
    mark("ntt_s")

    # 5) the toy circuit's proof with every MSM sharded
    proof = toy_proof(mesh_m)
    _check(proof["verifies"], "the sharded proof does not verify")
    _check(not proof["wrong_input_verifies"], "the sharded proof verifies a wrong public input")
    mark("prove_s")
    return {"world_size": n, "backend": torch.distributed.get_backend(),
            "device": str(dev), "steps_s": times}
