"""The reference's own Pedersen CRH and the public inputs it re-derives
from the seed, against the program's registrar and deep paths at small
sizes on the CPU, and a public input the program got wrong counted."""

import copy
import json
import os
import random
from types import SimpleNamespace

from conftest import ZKBENCH
from reference import pedersen_ref as ped
from reference.circuits import deep_path as deep_ref
from reference.circuits import registrar as reg_ref
from zkb import check as chk
from zkb import spec
from zkb.traffic import stream


def config(name: str, **changes) -> dict:
    with open(os.path.join(ZKBENCH, "configs", name + ".json")) as f:
        return dict(json.load(f), **changes)


def circuit(name: str):
    return spec.load_module(os.path.join(ZKBENCH, "circuits", name + ".py"), "test_circuit_" + name)


def test_the_curve_and_the_crh_are_the_programs():
    from zkmember_tpu_torch.app import circuits as app
    from zkmember_tpu_torch.curves import jubjub
    from zkmember_tpu_torch.hash import pedersen as ph

    E = ped.edwards("jubjub")
    assert E.gen == (jubjub.GENERATOR[0].v, jubjub.GENERATOR[1].v) and E.on_curve(E.gen)
    assert E.affine(E.mul(E.order, E.ext(E.gen))) == (0, 1)
    leaf, node = app.get_config("pedersen381").setup_params(stream(2**31 + 9, "crh"))
    mine_leaf, mine_node = ped.crh_pair(config("groth16-bls12_381-1024m")["pedersen"],
                                        stream(2**31 + 9, "crh"))
    rng = random.Random(5)
    for n in (0, 1, 17, 72):
        data = bytes(rng.randrange(256) for _ in range(n))
        assert mine_leaf.hash(data) == ph.hash_bytes_host(leaf, data).v
    data = bytes(rng.randrange(256) for _ in range(64))
    assert mine_node.hash(data) == ph.hash_bytes_host(node, data).v


def test_a_registrars_root_and_digests_are_rederived_from_the_seed():
    cfg = config("groth16-bls12_381-1024m", members=16)
    seed = 2**32 + 21
    reg = circuit("registrar").build(cfg, seed, "cpu")
    pool = [3, 12]
    want = reg_ref.publics(cfg, seed, pool)
    zs = {i: [int(v) for v in reg.synthesize(i).values] for i in pool}
    assert all(zs[i][1:3] == want[i] for i in pool)
    assert want[3][0] == want[12][0] and want[3][1] != want[12][1]
    ref = SimpleNamespace(ni=3, r=ped.edwards("jubjub").p)
    assert chk.publics_wrong(ref, [(zs[i], want[i]) for i in pool]) == 0
    other = reg_ref.publics(cfg, seed + 1, pool)  # another seed's CRH and join dates
    assert chk.publics_wrong(ref, [(zs[i], other[i]) for i in pool]) == 4


def test_a_deep_paths_root_and_digest_are_rederived_from_the_seed():
    cfg = config("groth16-bls12_381-depth32", depth=5)
    seed = 2**31 + 4
    reg = circuit("deep_path").build(cfg, seed, "cpu")
    pool = [7, 30]
    want = deep_ref.publics(cfg, seed, pool)
    for i in pool:
        z = [int(v) for v in reg.synthesize(i).values]
        assert z[1:3] == want[i]
    assert deep_ref.publics(cfg, seed, [7])[7] == want[7] != deep_ref.publics(cfg, seed + 1, [7])[7]


def test_a_crh_drawn_from_another_stream_changes_every_digest():
    pd = config("groth16-bls12_381-1024m")["pedersen"]
    a, _ = ped.crh_pair(pd, stream(1, "crh"))
    b, _ = ped.crh_pair(copy.deepcopy(pd), stream(2, "crh"))
    assert a.hash(b"1" * 20) != b.hash(b"1" * 20)
