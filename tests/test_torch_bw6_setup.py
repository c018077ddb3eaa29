"""The port's Groth16 setup and key checkpoints over BW6-761 against the JAX
reference.

On the toy cube circuit over BW6-761 Fr, the port's device setup
(fixed-base multiplications through the batch-major stack at n = 48, on
the CPU), its host setup and the JAX package's setup(host=True) draw the
same toxic waste from utils.rng.test_rng() and must give the same key:
equal query planes (G2's coordinates are single Fq planes, '<q>_x' and
'<q>_y'), index lists, points and verifying-key bytes.  A key saved by
either package loads in both.
"""

import numpy as np
import pytest
import torch

from zkmember_tpu.curves import bw6_761 as jbw6
from zkmember_tpu.r1cs import gadgets as jg
from zkmember_tpu.r1cs.cs import ConstraintSystem as JCS
from zkmember_tpu.snark import groth16 as jgroth16
from zkmember_tpu.utils import checkpoint as jcheckpoint
from zkmember_tpu.utils import rng as jrng
from zkmember_tpu.utils import serialize as jser
from zkmember_tpu_torch.curves import bw6_761 as bw6
from zkmember_tpu_torch.r1cs import gadgets as g
from zkmember_tpu_torch.r1cs.cs import ConstraintSystem
from zkmember_tpu_torch.snark import groth16, prove_lm
from zkmember_tpu_torch.utils import checkpoint
from zkmember_tpu_torch.utils import rng as frng
from zkmember_tpu_torch.utils import serialize as ser

QUERIES = ("a_query", "b_g1_query", "b_g2_query", "h_query", "l_query")


def cube_circuit(CS, gadgets, Fr, R):
    """tests/test_groth16.py's BW6-761 toy circuit: out = w^3 with w = 5."""
    cs = CS(Fr)
    out_val = pow(5, 3, R)
    out = gadgets.FpVar.new_input(cs, out_val)
    w = gadgets.FpVar.new_witness(cs, 5)
    (w * w * w).enforce_equal(out, "cube")
    return cs, out_val


def planes(pa):
    """A query's planes as {"x": ..., "y": ...} uint32 numpy."""
    out = {}
    for name, c in (("x", pa.x), ("y", pa.y)):
        for i, ci in enumerate(c if isinstance(c, tuple) else (c,)):
            arr = ci.numpy() if isinstance(ci, torch.Tensor) else np.asarray(ci)
            out[f"{name}{i if isinstance(c, tuple) else ''}"] = arr.astype(np.uint32)
    return out


def point_ints(pt):
    return [int(c.v) for c in pt]


def assert_same_key(pk, vk, other_pk, other_vk):
    for q in QUERIES:
        want, got = planes(getattr(pk, q)), planes(getattr(other_pk, q))
        assert sorted(want) == sorted(got) == ["x", "y"], q
        for k in want:
            assert want[k].shape[1] == 48 and np.array_equal(want[k], got[k]), (q, k)
    for attr in ("a_nonzero", "b_nonzero", "l_nonzero", "domain_size", "num_instance"):
        assert getattr(pk, attr) == getattr(other_pk, attr), attr
    assert point_ints(pk.beta_g1) == point_ints(other_pk.beta_g1)
    assert point_ints(pk.delta_g1) == point_ints(other_pk.delta_g1)
    assert jser.vk_to_bytes(jser.vk_from_bytes("bw6_761", ser.vk_to_bytes(vk))) == \
        ser.vk_to_bytes(other_vk)


@pytest.fixture(scope="module")
def keys():
    torch.set_num_threads(1)
    jcs, _ = cube_circuit(JCS, jg, jbw6.Fr, jbw6.R)
    cs, _ = cube_circuit(ConstraintSystem, g, bw6.Fr, bw6.R)
    jpk, jvk = jgroth16.setup(jcs, curve="bw6_761", rng=jrng.test_rng(), host=True)
    phases = {}
    pk, vk = groth16.setup(cs, "bw6_761", frng.test_rng(), device="cpu", phase_times=phases)
    return jpk, jvk, pk, vk, phases


def test_device_setup_equals_reference(keys):
    jpk, jvk, pk, vk, phases = keys
    assert set(phases) == {"qap", "fixed_base_tables", "gamma_abc", "a_query", "b_g1_query",
                           "b_g2_query", "h_query", "l_query", "vk"}
    assert isinstance(pk.b_g2_query.x, torch.Tensor)  # made on the device, as Fq rows
    assert_same_key(jpk, jvk, pk, vk)
    assert jser.vk_to_bytes(jvk) == ser.vk_to_bytes(vk)


def test_host_setup_equals_device_setup(keys):
    _, _, pk, vk, _ = keys
    cs, _ = cube_circuit(ConstraintSystem, g, bw6.Fr, bw6.R)
    hpk, hvk = groth16.setup(cs, "bw6_761", frng.test_rng(), host=True)
    assert_same_key(pk, vk, hpk, hvk)


def test_saved_keys_load_in_both_packages(keys, tmp_path):
    jpk, jvk, pk, vk, _ = keys
    path = str(tmp_path / "port")
    checkpoint.save_groth16_keys(path, pk)
    with np.load(path + ".npz") as data:
        assert "b_g2_query_x" in data.files and "b_g2_query_x_c0" not in data.files
    theirs = jcheckpoint.load_groth16_keys(path, device=False)
    assert_same_key(pk, vk, theirs, theirs.vk)
    mine = checkpoint.load_groth16_keys(path, device="cpu")
    assert_same_key(pk, vk, mine.pk, mine.pk.vk)
    assert mine.B1 == max(pk.domain_size, prove_lm.MIN_LANES) and mine.nwin == 95

    jpath = str(tmp_path / "reference")
    jcheckpoint.save_groth16_keys(jpath, jpk)
    mine = checkpoint.load_groth16_keys(jpath, device="cpu")
    assert_same_key(pk, vk, mine.pk, mine.pk.vk)
