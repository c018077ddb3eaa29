"""The port's batch-major NTT against the JAX reference.

Same random Montgomery rows (seeded random.Random) go through
zkmember_tpu.ntt (the v1 transforms) and zkmember_tpu_torch.ntt.ntt on the
CPU at N = 2^8, plain and stacked over a leading axis; outputs must match
bit for bit.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkmember_tpu import ntt as jntt
from zkmember_tpu.fields import device as jdv
from zkmember_tpu_torch.fields import spec as fs
from zkmember_tpu_torch.ntt import ntt

N = 256
TRANSFORMS = ("ntt", "intt", "coset_ntt", "coset_intt")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rows(seed, shape):
    rng = random.Random(seed)
    vals = [rng.randrange(fs.BLS_FR.p) for _ in range(int(np.prod(shape)))]
    a = fs.BLS_FR.to_mont_host(vals).reshape(tuple(shape) + (fs.BLS_FR.n,))
    return a, torch.from_numpy(a.astype(np.int32))


@pytest.mark.parametrize("name", TRANSFORMS)
def test_transform_matches_reference(name):
    jdom, dom = jntt.Domain.get(jdv.BLS_FR, N), ntt.Domain.get(fs.BLS_FR, N)
    x_np, x = _rows(1, (N,))
    want = np.asarray(getattr(jntt, name)(jdom, jnp.asarray(x_np)))
    got = getattr(ntt, name)(dom, x)
    assert got.shape == (N, fs.BLS_FR.n)
    assert np.array_equal(want.astype(np.int64), got.numpy().astype(np.int64))
    # three transforms stacked on a leading axis, as the H pipeline runs them
    x3_np, x3 = _rows(2, (3, N))
    got3 = getattr(ntt, name)(dom, x3)
    for i in range(3):
        want_i = np.asarray(getattr(jntt, name)(jdom, jnp.asarray(x3_np[i])))
        assert np.array_equal(want_i.astype(np.int64), got3[i].numpy().astype(np.int64))


def test_round_trips():
    dom = ntt.Domain.get(fs.BLS_FR, N)
    _, x = _rows(3, (N,))
    assert torch.equal(ntt.intt(dom, ntt.ntt(dom, x)), x)
    assert torch.equal(ntt.coset_intt(dom, ntt.coset_ntt(dom, x)), x)
