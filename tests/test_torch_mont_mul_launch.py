"""The field-product kernels' launch geometry, and their plain versions on the
operand patterns the provers send them.

K2 (``lm_cuda``) and K3 (``field_cuda``) read broadcast operands in place,
through element strides that a pure function of shapes and strides works
out (``launch_args``); the CPU reaches it without CUDA.  Each case below is
an operand pattern of the limb-major H pipeline (``ntt/lm.py``) or of the
v1 batch-major stack (``ntt/ntt.py``, ``fields/device.py``).  The strides
must address exactly the elements of the expanded operand (checked with
``torch.as_strided`` over the operand's own storage, as the kernel reads
it), and no pattern of the provers may need a copy.  The plain versions on
the same patterns equal the JAX package's ``fields.lm.mont_mul`` and
``fields.device.mont_mul`` on the same seeded numpy inputs, bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkmember_tpu.fields import device as jdv
from zkmember_tpu.fields import lm as jlm
from zkmember_tpu_torch.fields import field_cuda, lm_cuda, spec as fs

N = 16  # BLS12-381 Fr limbs
H = 8  # half the lanes of a toy domain

# (a's shape, b's shape): K2 operands are (..., n, B) planes
LM_PATTERNS = {
    "stage_twiddles": ((3, N, H), (N, H)),  # stacked iNTT / coset NTT stage
    "stage_twiddles_one": ((N, H), (N, H)),  # coset iNTT stage
    "column_stack": ((3, N, 2 * H), (N, 1)),  # 1 / N
    "coset_scale_stack": ((3, N, 2 * H), (N, 2 * H)),  # g^i
    "column": ((N, 2 * H), (N, 1)),  # 1 / Z_H, out of Montgomery form
    "equal_planes": ((N, 2 * H), (N, 2 * H)),  # A B
    "odd_lanes": ((2, N, 7), (N, 1)),
}
# K3 operands are (..., n) rows
BM_PATTERNS = {
    "constant_row": ((4 * H, N), (N,)),  # a (n,) constant against rows
    "constant_stack": ((3, H, N), (N,)),
    "twiddle_table": ((3, H, N), (H, N)),  # (N/2, n) table against (3, N/2, n)
    "equal_rows": ((H, N), (H, N)),
    "stacked_products": ((6, 2, H, N), (6, 2, H, N)),  # mul_many's stack
}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _limbs(shape, seed, axis):
    """Seeded values in [0, p) as int64 limbs along `axis` (numpy)."""
    rng = np.random.default_rng(seed)
    limbs = rng.integers(0, 1 << 16, size=shape, dtype=np.int64)
    top = np.take(limbs, [N - 1], axis=axis) % int(fs.BLS_FR.p_limbs[-1])
    np.put_along_axis(limbs, np.full_like(top, N - 1), top, axis=axis)
    return limbs


def _seen_by_kernel(x, strides, view_shape):
    """The elements a kernel reads from x at these element strides."""
    return torch.as_strided(x, view_shape, strides, x.storage_offset())


@pytest.mark.parametrize("name", sorted(LM_PATTERNS))
def test_lm_launch_args_read_operands_in_place(name):
    sa, sb = LM_PATTERNS[name]
    a = torch.from_numpy(_limbs(sa, 1, -2))
    b = torch.from_numpy(_limbs(sb, 2, -2))
    g = lm_cuda.launch_args(N, a.shape, a.stride(), b.shape, b.stride())
    assert not g.copy_a and not g.copy_b
    shape = torch.broadcast_shapes(a.shape, b.shape)
    assert g.shape == tuple(shape) and g.K * g.B * N == shape.numel()
    for x, st in ((a, g.a_strides), (b, g.b_strides)):
        assert torch.equal(_seen_by_kernel(x, st, (g.K, N, g.B)),
                           x.expand(shape).reshape(g.K, N, g.B))


@pytest.mark.parametrize("name", sorted(BM_PATTERNS))
def test_bm_launch_args_read_operands_in_place(name):
    sa, sb = BM_PATTERNS[name]
    a = torch.from_numpy(_limbs(sa, 3, -1))
    b = torch.from_numpy(_limbs(sb, 4, -1))
    g = field_cuda.launch_args(N, a.shape, a.stride(), True, b.shape, b.stride(), True)
    assert not g.copy_a and not g.copy_b
    shape = torch.broadcast_shapes(a.shape, b.shape)
    assert g.shape == tuple(shape) and g.outer * g.inner * N == shape.numel()
    for x, st in ((a, g.a_strides), (b, g.b_strides)):
        assert torch.equal(_seen_by_kernel(x, st + (1,), (g.outer, g.inner, N)),
                           x.expand(shape).reshape(g.outer, g.inner, N))


def test_launch_args_copy_only_what_cannot_be_read_in_place():
    # K2: leading axes broadcast crosswise fold into no single K stride
    a, b = torch.zeros(3, 1, N, H, dtype=torch.int32), torch.zeros(1, 4, N, H, dtype=torch.int32)
    g = lm_cuda.launch_args(N, a.shape, a.stride(), b.shape, b.stride())
    assert g.copy_a and g.copy_b and (g.K, g.B) == (12, H)
    assert g.a_strides == g.b_strides == (N * H, H, 1)  # the copies' strides
    # a lane-strided plane is read in place
    a = torch.zeros(N, 2 * H, dtype=torch.int32)[:, ::2]
    g = lm_cuda.launch_args(N, a.shape, a.stride(), a.shape, a.stride())
    assert not g.copy_a and g.a_strides == (0, 2 * H, 2)
    # K3: the same crosswise broadcast splits into (outer, inner) instead
    a, b = torch.zeros(3, 1, N, dtype=torch.int32), torch.zeros(1, 4, N, dtype=torch.int32)
    g = field_cuda.launch_args(N, a.shape, a.stride(), True, b.shape, b.stride(), True)
    assert not g.copy_a and not g.copy_b
    assert (g.outer, g.inner, g.a_strides, g.b_strides) == (3, 4, (N, 0), (0, N))
    # K3: limbs not contiguous, a row start off 16 bytes, or a row stride
    # off 16 bytes is copied
    c = torch.zeros(H, N, dtype=torch.int32)
    t = torch.zeros(N, H, dtype=torch.int32).T
    p = torch.zeros(H, N + 2, dtype=torch.int32)[:, :N]
    for x, aligned in ((t, True), (c, False), (p, True)):
        g = field_cuda.launch_args(N, x.shape, x.stride(), aligned, c.shape, c.stride(), True)
        assert g.copy_a and not g.copy_b and g.a_strides == (0, N)
    with pytest.raises(ValueError):
        lm_cuda.launch_args(N, (3, N + 1, H), (1, 1, 1), (N + 1, H), (H, 1))
    with pytest.raises(ValueError):
        field_cuda.launch_args(N, (2, H, N), (1, 1, 1), True, (3, H, N), (1, 1, 1), True)


@pytest.mark.parametrize("name", sorted(LM_PATTERNS))
def test_lm_plain_matches_reference(name):
    sa, sb = LM_PATTERNS[name]
    a, b = _limbs(sa, 5, -2), _limbs(sb, 6, -2)
    want = np.asarray(jlm.mont_mul(jdv.BLS_FR, jnp.asarray(a, jnp.uint32),
                                   jnp.asarray(b, jnp.uint32)))
    got = lm_cuda.mont_mul(fs.BLS_FR, torch.from_numpy(a).int(), torch.from_numpy(b).int())
    assert got.shape == want.shape
    assert np.array_equal(want.astype(np.int64), got.numpy().astype(np.int64))


@pytest.mark.parametrize("name", sorted(BM_PATTERNS))
def test_bm_plain_matches_reference(name):
    sa, sb = BM_PATTERNS[name]
    a, b = _limbs(sa, 7, -1), _limbs(sb, 8, -1)
    want = np.asarray(jdv.mont_mul(jdv.BLS_FR, jnp.asarray(a, jnp.uint32),
                                   jnp.asarray(b, jnp.uint32)))
    got = field_cuda.mont_mul_bm(fs.BLS_FR, torch.from_numpy(a).int(),
                                 torch.from_numpy(b).int())
    assert got.shape == want.shape
    assert np.array_equal(want.astype(np.int64), got.numpy().astype(np.int64))


@pytest.mark.parametrize("spec", [fs.BLS_FQ, fs.BW6_FQ], ids=lambda s: s.name)
def test_lm_plain_gives_the_broadcast_shape(spec):
    """A (1, n, 1) plane times an (n, 1) constant column (a one-row finish's
    doubling, ``swp_double``'s ``mul_consts``) is (1, n, 1), as the kernel
    gives it; the values are each row's product."""
    from zkmember_tpu_torch.fields import lm

    rng = np.random.default_rng(3)
    limbs = rng.integers(0, 1 << 16, size=(1, spec.n, 1), dtype=np.int64)
    limbs[:, -1] %= int(spec.p_limbs[-1])
    a = torch.as_tensor(limbs, dtype=torch.int32)
    k = lm.const_col(spec, 3, "cpu")
    got = lm_cuda.mont_mul_plain(spec, a, k)
    assert tuple(got.shape) == (1, spec.n, 1)
    assert torch.equal(got[0], lm_cuda.mont_mul_plain(spec, a[0], k))
