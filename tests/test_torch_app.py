"""The port's host modules (Pedersen, Merkle tree, membership circuit) and
its checkpoint loader against the JAX package."""

import json
import os
from datetime import datetime, timezone

import numpy as np
import pytest
import torch

from zkmember_tpu.snark import groth16 as jgroth16
from zkmember_tpu.utils import checkpoint as jcheckpoint
from zkmember_tpu.utils import rng as jrng
from zkmember_tpu.utils import serialize as jser
from zkmember_tpu_torch import device as devmod
from zkmember_tpu_torch.app import circuits as app
from zkmember_tpu_torch.app.member import Member
from zkmember_tpu_torch.fields import spec as fs
from zkmember_tpu_torch.utils import checkpoint, rng as frng
from zkmember_tpu_torch.utils import serialize as ser

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "root16.hex")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_membership_root16_matches_golden_and_circuit_satisfied():
    cfg = app.get_config("pedersen381")
    leaf_params, node_params = cfg.setup_params(frng.test_rng())
    epoch = datetime(2026, 1, 1, tzinfo=timezone.utc)  # as the golden was made
    ms = [Member(id=str(i), email=f"{i}@usc.edu", join_date=epoch) for i in range(1, 17)]
    digests = [m.hash(leaf_params) for m in ms]
    tree = app.new_membership_tree(leaf_params, node_params, digests)
    with open(GOLDEN) as f:
        assert ser.field_to_bytes(tree.root(), leaf_params.spec.p).hex() == f.read().strip()

    idx = 5
    circuit = app.MerkleTreeCircuit(
        config=cfg, leaf_params=leaf_params, node_params=node_params,
        root=tree.root(), leaf_hash=digests[idx], authentication_path=tree.generate_proof(idx),
    )
    assert circuit.generate_constraints().is_satisfied()
    bad = app.MerkleTreeCircuit(
        config=cfg, leaf_params=leaf_params, node_params=node_params,
        root=(tree.root() + 1) % cfg.scalar_field.p, leaf_hash=digests[idx],
        authentication_path=tree.generate_proof(idx),
    )
    assert not bad.generate_constraints().is_satisfied()


def _toy_key():
    from zkmember_tpu.curves import bls12_381 as jbls
    from zkmember_tpu.r1cs import gadgets as jg
    from zkmember_tpu.r1cs.cs import ConstraintSystem

    cs = ConstraintSystem(jbls.Fr)
    out = jg.FpVar.new_input(cs, 27)
    w = jg.FpVar.new_witness(cs, 3)
    (w * w * w).enforce_equal(out, "cube")
    return jgroth16.setup(cs, curve="bls12_381", rng=jrng.test_rng(), host=True)


def test_checkpoint_loads_reference_key(tmp_path):
    """A key saved by the JAX package loads into the port unchanged; the
    sha256 gate rejects a tampered npz; a meta without the hash loads."""
    pk, vk = _toy_key()
    path = str(tmp_path / "toy")
    jcheckpoint.save_groth16_keys(path, pk)
    keys = checkpoint.load_groth16_keys(path, device="cpu")
    got = keys.pk
    assert got.domain_size == pk.domain_size and got.num_instance == pk.num_instance
    assert got.a_nonzero == list(pk.a_nonzero) and got.l_nonzero == list(pk.l_nonzero)
    assert np.array_equal(got.h_query.x, np.asarray(pk.h_query.x))
    assert np.array_equal(got.b_g2_query.y[1], np.asarray(pk.b_g2_query.y[1]))
    assert ser.vk_to_bytes(got.vk) == jser.vk_to_bytes(vk)
    # device planes: (4, n, lanes) G1 rows, lanes padded to the kernel tile
    assert keys.g1_X.shape == (4, fs.BLS_FQ.n, 64) and keys.g1_X.dtype == torch.int32

    with open(path + ".json") as f:
        meta = json.load(f)
    meta["npz_sha256"] = "0" * 64
    with open(path + ".json", "w") as f:
        json.dump(meta, f)
    with pytest.raises(ValueError, match="sha256"):
        checkpoint.load_groth16_keys(path, device="cpu")
    del meta["npz_sha256"]
    with open(path + ".json", "w") as f:
        json.dump(meta, f)
    assert checkpoint.load_groth16_keys(path, device="cpu").pk.domain_size == pk.domain_size


def test_keys_reject_more_lanes_than_the_domain():
    from zkmember_tpu_torch.snark import groth16, prove_lm

    pk, _ = _toy_key()
    planes = {}
    for name in ("a_query", "b_g1_query", "b_g2_query", "h_query", "l_query"):
        pa = getattr(pk, name)
        for cn, c in (("x", pa.x), ("y", pa.y)):
            if isinstance(c, tuple):
                for i, ci in enumerate(c):
                    planes[f"{name}_{cn}_c{i}"] = np.asarray(ci)
            else:
                planes[f"{name}_{cn}"] = np.asarray(c)
    g1 = (int(pk.delta_g1[0].v), int(pk.delta_g1[1].v))
    g2 = tuple(tuple(int(c.v) for c in v.coeffs) for v in pk.vk.beta_g2)
    kw = dict(curve="bls12_381", a_nonzero=pk.a_nonzero, b_nonzero=pk.b_nonzero,
              l_nonzero=pk.l_nonzero, num_instance=pk.num_instance,
              vk={"alpha_g1": g1, "beta_g2": g2, "gamma_g2": g2, "delta_g2": g2,
                  "gamma_abc_g1": [g1, g1]},
              beta_g1=g1, delta_g1=g1, device="cpu")
    assert prove_lm.keys_from_numpy(planes, domain_size=pk.domain_size, **kw).M == pk.domain_size
    with pytest.raises(ValueError, match="exceed the domain size"):
        prove_lm.keys_from_numpy(planes, domain_size=pk.domain_size // 2, **kw)
    with pytest.raises(ValueError, match="unsupported curve"):
        groth16.pairing_config("bn254")


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        devmod.resolve(None)
    assert devmod.resolve("cpu").type == "cpu"
