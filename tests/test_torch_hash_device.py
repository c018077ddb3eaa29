"""The port's device Pedersen hash, Merkle levels, ``Member.hash_batch`` and
``entry`` against the JAX package, bit for bit, on the CPU (plain K3).

Both stacks: pedersen381 (Jubjub over BLS12-381 Fr; windows 4x144 leaf,
4x128 node) and pedersen761 (Ed377 over BW6-761 Fr; 4x192 both).  The CRH
parameters of both packages come from the same test rng; every device call
of the JAX package takes a batch of 8 rows (its CPU hash tile), so its
``_hash_kernel`` compiles once per window shape.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from zkmember_tpu.app import circuits as japp
from zkmember_tpu.app import member as jmember
from zkmember_tpu.hash import pedersen as jph
from zkmember_tpu.merkle import tree as jtree
from zkmember_tpu.utils import rng as jrng
from zkmember_tpu_torch import entry
from zkmember_tpu_torch.app import circuits as app
from zkmember_tpu_torch.app import member
from zkmember_tpu_torch.fields import spec as fs
from zkmember_tpu_torch.hash import pedersen as ph
from zkmember_tpu_torch.merkle import tree
from zkmember_tpu_torch.utils import rng as frng

B = 8


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module", params=["pedersen381", "pedersen761"])
def stack(request):
    """(name, port leaf, port node, JAX leaf, JAX node) CRH parameters.
    pedersen761's leaf and node windows are one shape (4x192), so there
    the leaf parameters serve as both: the JAX package's affine sampling
    takes about 12 s a set."""
    name = request.param
    cfg, jcfg = app.get_config(name), japp.get_config(name)
    if name == "pedersen761":
        leaf = ph.PedersenParams(cfg.te_curve, cfg.leaf_window, frng.test_rng())
        jleaf = jph.PedersenParams(jcfg.te_curve, jcfg.leaf_window, jrng.test_rng())
        return name, leaf, leaf, jleaf, jleaf
    leaf, node = cfg.setup_params(frng.test_rng())
    jleaf, jnode = jcfg.setup_params(jrng.test_rng())
    return name, leaf, node, jleaf, jnode


def _messages(params, seed):
    rng = np.random.default_rng(seed)
    cap = params.window.capacity_bytes
    msgs = [bytes(rng.integers(0, 256, size=int(rng.integers(0, cap + 1)), dtype=np.uint8))
            for _ in range(B - 2)]
    return msgs + [b"", bytes([255]) * cap]


def _bits(params, msgs):
    return np.stack([ph.bytes_to_bits(m, params.window.capacity_bits) for m in msgs])


def _tensor(a):
    return torch.as_tensor(np.asarray(a).astype(np.int32))


def test_params_tables_equal_reference(stack):
    _, *params = stack
    leaf, node, jleaf, jnode = params
    for port, ref in ((leaf, jleaf), (node, jnode)):
        assert (port.window.window_size, port.window.num_windows, port.spec.p) == (
            ref.window.window_size, ref.window.num_windows, ref.spec.p)
        for name in ("table_x", "table_y", "digit_x", "digit_y", "digit_t"):
            got, want = getattr(port, name), np.asarray(getattr(ref, name))
            assert got.dtype == want.dtype and np.array_equal(got, want), name
        assert np.array_equal(port.consts.a, ref.consts.a)
        assert np.array_equal(port.consts.d, ref.consts.d)
        tables = port.device_tables("cpu")
        assert tables is port.device_tables(torch.device("cpu"))
        assert np.array_equal(tables.digit_t.numpy().astype(np.uint32), port.digit_t)


def test_bytes_to_bits_equals_reference(stack):
    _, leaf, _, _, _ = stack
    cap = leaf.window.capacity_bits
    for m in _messages(leaf, 5):
        assert np.array_equal(ph.bytes_to_bits(m, cap), jph.bytes_to_bits(m, cap))
    with pytest.raises(ValueError):
        ph.bytes_to_bits(bytes(cap // 8 + 1), cap)


@pytest.mark.parametrize("which", ["leaf", "node"])
def test_hash_bits_device_equals_reference_and_host(stack, which):
    _, leaf, node, jleaf, jnode = stack
    port, ref = (leaf, jleaf) if which == "leaf" else (node, jnode)
    msgs = _messages(port, 1 if which == "leaf" else 2)
    bits = _bits(port, msgs)
    got = ph.hash_bits_device(port, _tensor(bits))
    assert got.dtype == torch.int32 and got.shape == (B, port.spec.n)
    want = np.asarray(jph.hash_bits_device(ref, jnp.asarray(bits)))
    assert np.array_equal(got.numpy().astype(np.uint32), want)
    assert fs.limbs_to_ints(got.numpy()) == [ph.hash_bytes_host(port, m).v for m in msgs]


def test_hash_bits_tiled_any_tile_equals_one_call(stack):
    _, leaf, _, _, _ = stack
    bits = _bits(leaf, _messages(leaf, 3))
    one = ph.hash_bits_device(leaf, _tensor(bits)).numpy().astype(np.uint32)
    for tile in (3, B, 64):
        got = ph.hash_bits_tiled(leaf, bits, "cpu", tile=tile)
        assert got.dtype == np.uint32 and np.array_equal(got, one)
    assert ph.hash_tile("cpu") == 64 and ph.hash_tile("cuda") == 1024


def test_digest_bits_and_two_to_one_equal_reference(stack):
    _, _, node, _, jnode = stack
    spec = node.spec
    r = random.Random(7)
    left = fs.ints_to_limbs([r.randrange(spec.p) for _ in range(B)], spec.n)
    right = fs.ints_to_limbs([r.randrange(spec.p) for _ in range(B)], spec.n)
    half = node.window.capacity_bits // 2
    for nbits in (half, half - 5, half + 16):
        want = np.asarray(jph.digests_to_bits_device(jnode.spec, jnp.asarray(left), nbits))
        got = ph.digests_to_bits_device(spec, _tensor(left), nbits)
        assert got.dtype == torch.int32 and np.array_equal(got.numpy().astype(np.uint32), want)
        assert np.array_equal(ph.limbs_to_bits_np(left, nbits), jph.limbs_to_bits_np(left, nbits))
    want = np.asarray(jph.two_to_one_device(jnode, jnp.asarray(left), jnp.asarray(right)))
    got = ph.two_to_one_device(node, _tensor(left), _tensor(right))
    assert np.array_equal(got.numpy().astype(np.uint32), want)
    tiled = ph.two_to_one_tiled(node, left, right, "cpu", tile=5)
    assert np.array_equal(tiled, jph.two_to_one_tiled(jnode, left, right))
    nbytes = spec.n * 2
    assert fs.limbs_to_ints(tiled)[:2] == [
        ph.two_to_one_host(node, int(a).to_bytes(nbytes, "little"),
                           int(b).to_bytes(nbytes, "little")).v
        for a, b in zip(fs.limbs_to_ints(left[:2]), fs.limbs_to_ints(right[:2]))]


def test_device_tree_levels_equal_host_and_reference(stack):
    _, leaf, node, jleaf, jnode = stack
    nbytes = node.spec.n * 2
    r = random.Random(11)
    leaves = [r.randrange(node.spec.p).to_bytes(nbytes, "little") for _ in range(B)]
    dev = tree.MerkleTree(leaf, node, leaves, backend="device", device="cpu")
    host = tree.MerkleTree(leaf, node, leaves, backend="host")
    ref = jtree.MerkleTree(jleaf, jnode, leaves, backend="device")
    assert len(dev.levels) == len(host.levels) == len(ref.levels) == 4
    for d, h, j in zip(dev.levels, host.levels, ref.levels):
        assert d.dtype == h.dtype == np.uint32
        assert np.array_equal(d, h) and np.array_equal(d, np.asarray(j))
    assert dev.root() == host.root() == ref.root()
    path = dev.generate_proof(5)
    assert tree.path_verify_host(leaf, node, dev.root(), leaves[5], path)


def test_auto_backend_is_chosen_by_size(monkeypatch):
    """"auto" hashes up to 64 leaves on the host (no device is resolved, so
    a card is not needed) and on the device above; "device" without a card
    and without device="cpu" raises."""
    cfg = app.get_config("pedersen381")
    leaf, node = cfg.setup_params(frng.test_rng())
    calls = []
    monkeypatch.setattr(ph, "hash_bits_tiled", lambda *a, **k: calls.append(a[2]) or 1 / 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    leaves = [bytes([i]) for i in range(2)]
    tree.MerkleTree(leaf, node, leaves, device="cuda")  # host: no error
    with pytest.raises(ZeroDivisionError):
        tree.MerkleTree(leaf, node, [bytes([i % 256]) for i in range(128)], device="cpu")
    assert calls == [torch.device("cpu")]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tree.MerkleTree(leaf, node, leaves, backend="device")
    with pytest.raises(ValueError, match="backend"):
        tree.MerkleTree(leaf, node, leaves, backend="gpu")


def test_hash_batch_equals_member_hash(stack):
    name, leaf, _, jleaf, _ = stack
    members = member.generate_members(B - 1) + [member.Member.default()]
    got = member.Member.hash_batch(leaf, members, device="cpu")
    assert got == [m.hash(leaf) for m in members]
    jmembers = [jmember.Member(m.id, m.email, m.join_date, m.end_date, m.padding)
                for m in members]
    assert got == jmember.Member.hash_batch(jleaf, jmembers)
    assert member.Member.hash_batch(leaf, [], device="cpu") == []


def test_membership_tree_passes_the_device(monkeypatch):
    cfg = app.get_config("pedersen381")
    leaf, node = cfg.setup_params(frng.test_rng())
    seen = []
    monkeypatch.setattr(app, "MerkleTree", lambda *a, **k: seen.append(k))
    app.new_membership_tree(leaf, node, [1, 2], device="cpu")
    assert seen == [{"device": "cpu"}]


def test_entry_equals_graft_entry():
    fn, (left, right) = entry.entry("cpu")
    jfn, (jleft, jright) = __graft_entry__.entry()
    assert np.array_equal(left.numpy().astype(np.uint32), np.asarray(jleft))
    assert np.array_equal(right.numpy().astype(np.uint32), np.asarray(jright))
    got = fn(left, right)
    assert got.shape == (entry.BATCH, 16)
    assert np.array_equal(got.numpy().astype(np.uint32), np.asarray(jfn(jleft, jright)))
