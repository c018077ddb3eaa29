"""Limb-major NTT and the Groth16 H pipeline (counterpart of zkmember_tpu.ntt.lm).

Constant-geometry (Pease) radix-2 DIF along the lane axis of (..., n, N)
Montgomery planes: log N identical stages of butterflies (a + b,
(a - b) w) with a perfect shuffle, then one bit-reverse gather.  Every
product goes through ``fields.lm.mont_mul`` (kernel K2 on the card).
"""

from __future__ import annotations

import torch

from zkmember_tpu_torch.fields import lm
from zkmember_tpu_torch.fields.spec import FieldSpec, to_lm
from zkmember_tpu_torch.ntt.ntt import Domain


class DomainLM:
    """Device-resident limb-major twiddle/coset tables for one Domain.

    Built once per (field, size, device) and cached."""

    _CACHE: dict = {}

    @classmethod
    def get(cls, spec: FieldSpec, size: int, device) -> "DomainLM":
        key = (spec.p, size, str(torch.device(device)))
        if key not in cls._CACHE:
            cls._CACHE[key] = cls(Domain.get(spec, size), device)
        return cls._CACHE[key]

    def __init__(self, domain: Domain, device):
        def dev(a):
            return torch.as_tensor(a.astype("int64"), dtype=torch.int32, device=device)

        self.domain = domain
        self.spec = domain.spec
        self.size = domain.size
        self.device = torch.device(device)
        # (log N, n, N/2) stage twiddles, forward + inverse
        self.tw_fwd = dev(to_lm(domain._twiddles(False)))
        self.tw_inv = dev(to_lm(domain._twiddles(True)))
        # (n, N) coset scale tables (inverse table folds in 1/N)
        self.coset_fwd = dev(to_lm(domain._coset_powers(False)))
        self.coset_inv = dev(to_lm(domain._coset_powers(True)))
        self.size_inv = lm.const_col(self.spec, domain.size_inv, device)
        self.perm = torch.as_tensor(domain._perm, device=device)
        self.zh_coset_inv = lm.const_col(
            self.spec, pow(domain.vanishing_on_coset(), -1, self.spec.p), device
        )


def _fft_core(spec: FieldSpec, x, twiddles, perm):
    """Pease radix-2 DIF along the last axis; x: (..., n, N) Montgomery."""
    half = x.shape[-1] // 2
    for tw in twiddles:
        a = x[..., :half]
        b = x[..., half:]
        sm = lm.add(spec, a, b)
        df = lm.mont_mul(spec, lm.sub(spec, a, b), tw)
        x = torch.stack([sm, df], dim=-1).reshape(x.shape)
    return x[..., perm]


def ntt(spec: FieldSpec, x, twiddles, perm):
    return _fft_core(spec, x, twiddles, perm)


def h_pipeline(spec: FieldSpec, abc, tw_inv, tw_fwd, perm, coset_fwd, coset_inv,
               size_inv, zh_inv):
    """Stacked Groth16 H: abc (..., 3, n, N) mont evals -> (..., n, N)
    canonical coefficients of (A*B - C) / Z_H on the coset."""
    x = _fft_core(spec, abc, tw_inv, perm)  # iNTT (unscaled)
    x = lm.mont_mul(spec, x, size_inv)  # 1/N
    x = lm.mont_mul(spec, x, coset_fwd)  # scale by g^i
    x = _fft_core(spec, x, tw_fwd, perm)  # coset evals
    xa, xb, xc = x.unbind(-3)
    ab = lm.mont_mul(spec, xa, xb)
    hh = lm.sub(spec, ab, xc)
    hh = lm.mont_mul(spec, hh, zh_inv)
    hh = _fft_core(spec, hh, tw_inv, perm)
    hh = lm.mont_mul(spec, hh, coset_inv)  # g^-i / N
    return lm.from_mont(spec, hh)  # canonical limbs (digit source for MSM)


def groth16_h(dlm: DomainLM, da, db, dc):
    """da/db/dc: (n, N) Montgomery matrix-eval planes -> canonical H limbs."""
    return groth16_h_batch(dlm, torch.stack([da, db, dc]))


def groth16_h_batch(dlm: DomainLM, dabc):
    """dabc: ([P,] 3, n, N) Montgomery planes of P proofs -> ([P,] n, N)
    canonical H limbs, every stage one product over all P proofs."""
    return h_pipeline(
        dlm.spec,
        dabc,
        dlm.tw_inv,
        dlm.tw_fwd,
        dlm.perm,
        dlm.coset_fwd,
        dlm.coset_inv,
        dlm.size_inv,
        dlm.zh_coset_inv,
    )
