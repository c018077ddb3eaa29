"""Radix-2 evaluation domain and the batch-major NTT (counterpart of zkmember_tpu.ntt.ntt).

``Domain`` holds the host-side twiddle, coset and permutation tables; it
mirrors ark-poly's Radix2EvaluationDomain: generator w of order N,
vanishing polynomial Z(x) = x^N - 1, and a multiplicative coset with the
field's multiplicative generator (used by the Groth16 H step).  The
limb-major transforms over these tables live in ``ntt.lm``; the
batch-major ones (``ntt``, ``intt``, ``coset_ntt``, ``coset_intt``, for the
v1 prover) are below, with every product on ``fields.device.mont_mul``
(kernel K3 on the card).
"""

from __future__ import annotations

import numpy as np
import torch

from zkmember_tpu_torch import native
from zkmember_tpu_torch.fields import device as dv
from zkmember_tpu_torch.fields.spec import FieldSpec


def _bit_reverse_perm(n: int) -> np.ndarray:
    logn = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, np.int64)
    for b in range(logn):
        rev |= ((idx >> b) & 1) << (logn - 1 - b)
    return rev


_DOMAIN_CACHE: dict = {}


def _geom_mont(spec: FieldSpec, count: int, base: int, scale: int) -> np.ndarray:
    """[scale, scale base, ..., scale base^(count - 1)] as (count, n) Montgomery
    limbs: the native library's sequence where it is built, else Python
    bignums (the same values)."""
    nf = native.NativeField.get(spec.p, spec.n)
    if nf is None:
        seq = [scale % spec.p] * count
        for k in range(1, count):
            seq[k] = seq[k - 1] * base % spec.p
        return spec.to_mont_host(seq)
    rows = nf.geom_seq(count, nf.ints_to_mont([base])[0], nf.ints_to_mont([scale])[0])
    return native.u64_to_u16_planes(rows)


class Domain:
    """Power-of-two evaluation domain over a device field.

    Mirrors ark-poly's Radix2EvaluationDomain: generator w of order N,
    vanishing polynomial Z(x) = x^N - 1, and a multiplicative coset with
    the field's multiplicative generator (used by the Groth16 H step).

    Use Domain.get() for a cached instance: the host tables are built once.
    """

    @classmethod
    def get(cls, spec: FieldSpec, size: int) -> "Domain":
        key = (spec.p, size)
        if key not in _DOMAIN_CACHE:
            _DOMAIN_CACHE[key] = cls(spec, size)
        return _DOMAIN_CACHE[key]

    def __init__(self, spec: FieldSpec, size: int):
        if size & (size - 1) or size < 2:
            raise ValueError("domain size must be a power of two >= 2")
        two_adicity = getattr(spec, "two_adicity")
        if size > (1 << two_adicity):
            raise ValueError("domain too large for field 2-adicity")
        self.spec = spec
        self.size = size
        p = spec.p
        root = getattr(spec, "two_adic_root")  # order 2^two_adicity
        self.w = pow(root, (1 << two_adicity) // size, p)
        self.w_inv = pow(self.w, -1, p)
        self.size_inv = pow(size, -1, p)
        self.coset_gen = getattr(spec, "mult_gen")
        self.coset_gen_inv = pow(self.coset_gen, -1, p)
        self._perm = _bit_reverse_perm(size)
        self._stage_tw: dict[bool, list[np.ndarray]] = {}
        self._coset_pows: dict[bool, np.ndarray] = {}

    # -- host-side constant tables (built once, shipped to the device) -------
    def _twiddles(self, inverse: bool) -> np.ndarray:
        """Stacked Pease-stage twiddle table, shape (log N, N/2, n_limbs).

        Stage s of the constant-geometry DIF uses w^((i >> s) << s) at
        butterfly lane i (verified against the naive DFT; see module doc):
        a geometric sequence in w^(2^s) of length N/2^(s+1), each term
        repeated 2^s times.
        """
        if inverse not in self._stage_tw:
            p, N = self.spec.p, self.size
            w = self.w_inv if inverse else self.w
            logn = N.bit_length() - 1
            self._stage_tw[inverse] = np.stack([
                np.repeat(_geom_mont(self.spec, N >> (s + 1), pow(w, 1 << s, p), 1), 1 << s,
                          axis=0)
                for s in range(logn)
            ])
        return self._stage_tw[inverse]

    def _coset_powers(self, inverse: bool) -> np.ndarray:
        """[c g^j for j < N] in Montgomery form: c = 1 and g the coset
        generator, or c = 1/N and g its inverse."""
        if inverse not in self._coset_pows:
            if inverse:
                seq = _geom_mont(self.spec, self.size, self.coset_gen_inv, self.size_inv)
            else:
                seq = _geom_mont(self.spec, self.size, self.coset_gen, 1)
            self._coset_pows[inverse] = seq
        return self._coset_pows[inverse]

    def vanishing_on_coset(self) -> int:
        """Z_H(g x) = g^N - 1, constant across the coset."""
        return (pow(self.coset_gen, self.size, self.spec.p) - 1) % self.spec.p


# ---------------------------------------------------------------------------
# batch-major transforms: x is (..., N, n) Montgomery rows, natural order
# ---------------------------------------------------------------------------

_DEV_TABLES: dict = {}


def _dev_table(domain: Domain, name: str, inverse: bool, device) -> torch.Tensor:
    """A host table of `domain` as an int32 tensor on `device` (cached)."""
    key = (domain.spec.p, domain.size, name, inverse, str(torch.device(device)))
    t = _DEV_TABLES.get(key)
    if t is None:
        if name == "twiddles":
            arr = domain._twiddles(inverse)
        elif name == "coset":
            arr = domain._coset_powers(inverse)
        else:  # the bit-reverse permutation
            arr = domain._perm
        t = _DEV_TABLES[key] = torch.as_tensor(
            np.asarray(arr).astype(np.int64),
            dtype=torch.int64 if name == "perm" else torch.int32, device=device)
    return t


def _fft_core(domain: Domain, x, inverse: bool):
    """Constant-geometry (Pease) radix-2 DIF over the last-but-one axis:
    log N identical stages of butterflies (a + b, (a - b) w) and a perfect
    shuffle, then one bit-reverse gather to natural order."""
    spec = domain.spec
    half = domain.size // 2
    for tw in _dev_table(domain, "twiddles", inverse, x.device):  # (N/2, n) per stage
        a = x[..., :half, :]
        b = x[..., half:, :]
        sm = dv.add(spec, a, b)
        df = dv.mont_mul(spec, dv.sub(spec, a, b), tw)
        x = torch.stack([sm, df], dim=-2).reshape(x.shape)
    return x[..., _dev_table(domain, "perm", False, x.device), :]


def _fft_core_axis(domain: Domain, x, axis: int, inverse: bool):
    """``_fft_core`` along any axis but the limb axis, which stays last (the
    row and column transforms of ``parallel.dist.sharded_ntt``)."""
    axis = axis % x.ndim
    if axis == x.ndim - 2:
        return _fft_core(domain, x, inverse)
    return _fft_core(domain, x.movedim(axis, -2), inverse).movedim(-2, axis)


def ntt(domain: Domain, coeffs):
    """Coefficients -> evaluations over the domain (Montgomery form)."""
    return _fft_core(domain, coeffs, inverse=False)


def intt(domain: Domain, evals):
    """Evaluations -> coefficients: inverse NTT with 1/N scaling."""
    x = _fft_core(domain, evals, inverse=True)
    scale = dv.FpOps(domain.spec, x.device).const(domain.size_inv)
    return dv.mont_mul(domain.spec, x, scale)


def coset_ntt(domain: Domain, coeffs):
    """Evaluations over the coset g*H: scale coeffs by g^i, then NTT."""
    pows = _dev_table(domain, "coset", False, coeffs.device)
    return _fft_core(domain, dv.mont_mul(domain.spec, coeffs, pows), inverse=False)


def coset_intt(domain: Domain, evals):
    """Inverse of coset_ntt: iNTT then scale by g^-i / N (one fused table)."""
    x = _fft_core(domain, evals, inverse=True)
    return dv.mont_mul(domain.spec, x, _dev_table(domain, "coset", True, x.device))
