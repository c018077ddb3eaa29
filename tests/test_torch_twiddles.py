"""The port's NTT domain tables, built with the native library's geometric
sequences, against the JAX package's ``Domain`` tables, bit for bit.

BLS12-381 Fr (16 limbs) and BW6-761 Fr (24 limbs) at 2^10..2^12: the
stacked Pease twiddles forward and inverse, and the coset powers both ways
(g^j, and N^-1 g^-j).  A second case holds the Python-bignum sequence the
port keeps for a host without the native library.
"""

import numpy as np
import pytest

from zkmember_tpu.fields import device as dv
from zkmember_tpu.ntt.ntt import Domain as JDomain
from zkmember_tpu_torch import native
from zkmember_tpu_torch.fields import spec as fs
from zkmember_tpu_torch.ntt import ntt as port_ntt

FIELDS = [(dv.BLS_FR, fs.BLS_FR), (dv.BW6_FR, fs.BW6_FR)]


@pytest.mark.parametrize("log_n", [10, 11, 12])
@pytest.mark.parametrize("fields", FIELDS, ids=["bls12_381_fr", "bw6_761_fr"])
def test_native_tables_equal_reference(fields, log_n):
    jspec, spec = fields
    assert native.available()
    ref = JDomain(jspec, 1 << log_n)
    port = port_ntt.Domain(spec, 1 << log_n)
    for inverse in (False, True):
        tw = port._twiddles(inverse)
        assert tw.dtype == ref._twiddles(inverse).dtype
        assert np.array_equal(tw, ref._twiddles(inverse))
        assert np.array_equal(port._coset_powers(inverse), ref._coset_powers(inverse))


@pytest.mark.parametrize("fields", FIELDS, ids=["bls12_381_fr", "bw6_761_fr"])
def test_python_sequence_equals_native(fields, monkeypatch):
    _, spec = fields
    base, scale = spec.mult_gen, pow(1 << 9, -1, spec.p)
    native_rows = port_ntt._geom_mont(spec, 512, base, scale)
    monkeypatch.setattr(port_ntt.native.NativeField, "get", classmethod(lambda *a: None))
    python_rows = port_ntt._geom_mont(spec, 512, base, scale)
    assert np.array_equal(native_rows, python_rows)
    assert python_rows.dtype == native_rows.dtype == np.uint32
