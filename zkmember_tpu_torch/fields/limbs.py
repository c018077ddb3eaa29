"""Exact multi-limb integer helpers on limb-major planes (plain PyTorch).

Planes are ``(..., L, B)`` tensors of 16-bit limbs along axis -2.  These
helpers carry the field ops of ``fields.lm`` and the plain version of the
Montgomery kernel (``fields.lm_cuda.mont_mul_plain``); they run on any
device.  Column sums are int64; limbs come back in the input's dtype.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from zkmember_tpu_torch.fields.spec import LIMB_BITS, LIMB_MASK

_CONSTS: dict = {}
_GRID_MAX = 1 << 16  # product-grid elements above which mul_cols loops


def const_limbs(limbs, device, dtype=torch.int32) -> torch.Tensor:
    """A numpy limb vector as an (n, 1) column on `device` (cached)."""
    key = (limbs.dtype.str, limbs.tobytes(), str(device), dtype)
    t = _CONSTS.get(key)
    if t is None:
        t = torch.as_tensor(limbs.astype("int64"), dtype=dtype, device=device).view(-1, 1)
        _CONSTS[key] = t
    return t


def _unit(n: int) -> np.ndarray:
    u = np.zeros(n, np.uint32)
    u[0] = 1
    return u


def shift_up(x: torch.Tensor, k: int) -> torch.Tensor:
    """Move limb i to limb i + k (zero fill, overflow dropped)."""
    L = x.shape[-2]
    if k >= L:
        return torch.zeros_like(x)
    return F.pad(x[..., : L - k, :], (0, 0, k, 0))


def _arange_col(L: int, device) -> torch.Tensor:
    key = ("arange", L, str(device))
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.arange(L, device=device).view(L, 1)
    return t


def propagate(s: torch.Tensor):
    """Digits s < 2^17 -> (16-bit limbs, carry out of the top limb).

    With the digits moved up one limb (row j holds s_{j-1}, row 0 is 0),
    the carry into limb j is the generate bit (s_i >> 16) of the nearest
    row i <= j whose digit does not propagate (s_i != 2^16 - 1); row 0
    never propagates and generates nothing.  One running maximum over row
    indices finds that row, one gather reads its bit."""
    L = s.shape[-2]
    up = F.pad(s, (0, 0, 1, 0))  # (..., L + 1, B)
    row = _arange_col(L + 1, s.device) * (up != LIMB_MASK)
    cin = torch.gather(up >> LIMB_BITS, -2, row.cummax(dim=-2).values)
    return (s + cin[..., :L, :]) & LIMB_MASK, cin[..., L, :]


def carry(cols: torch.Tensor, out_len: int) -> torch.Tensor:
    """Non-negative int64 column sums (< 2^47) -> out_len 16-bit limbs,
    mod 2^(16 out_len)."""
    L = cols.shape[-2]
    if L < out_len:
        cols = F.pad(cols, (0, 0, 0, out_len - L))
    else:
        cols = cols[..., :out_len, :]
    s = (
        (cols & LIMB_MASK)
        + shift_up((cols >> LIMB_BITS) & LIMB_MASK, 1)
        + shift_up(cols >> (2 * LIMB_BITS), 2)
    )  # < 2^18
    s = (s & LIMB_MASK) + shift_up(s >> LIMB_BITS, 1)  # < 2^16 + 4
    return propagate(s)[0]


def mul_cols(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook column sums of a * b: (..., n, B) x (..., m, B) int64 ->
    (..., n + m - 1, B) int64, uncarried.

    Small operands form the whole (n, m) product grid at once: padded to
    (n, n + m) and re-read with row length n + m - 1, row i shifts right
    by i, so a sum over rows adds every a_i b_j into column i + j (few ops,
    which is what costs at the Horner join's single lanes).  Large
    operands take n row passes instead, which keep memory at the output's
    size."""
    if _is_column(a):
        a, b = b, a
    if _is_column(b):
        return _mul_column(a, b)
    n, m = a.shape[-2], b.shape[-2]
    shape = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    B = max(a.shape[-1], b.shape[-1])
    if math.prod(shape) * n * m * B <= _GRID_MAX:
        prod = a.unsqueeze(-2) * b.unsqueeze(-3)  # (..., n, m, B)
        lead = prod.shape[:-3]
        prod = F.pad(prod, (0, 0, 0, n))  # (..., n, n + m, B)
        flat = prod.reshape(lead + (n * (n + m), B))[..., : n * (n + m - 1), :]
        return flat.reshape(lead + (n, n + m - 1, B)).sum(dim=-3)
    cols = torch.zeros(shape + (n + m - 1, B), dtype=torch.int64, device=a.device)
    for i in range(n):
        cols[..., i : i + m, :] += a[..., i : i + 1, :] * b
    return cols


def _is_column(x: torch.Tensor) -> bool:
    """x is one (m, 1) limb column, broadcast over every plane and lane."""
    return x.shape[-1] == 1 and math.prod(x.shape[:-2]) == 1


def _mul_column(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """mul_cols of (..., n, B) planes by one (m, 1) column (a constant such
    as p or N'): one float64 product with c's (n + m - 1, n) Toeplitz
    matrix.  Exact: each term is below 2^32 and a column sums at most
    min(n, m) of them, far below 2^53."""
    n, m = a.shape[-2], c.shape[-2]
    k = _arange_col(n + m - 1, a.device) - _arange_col(n, a.device).view(1, n)
    col = c.reshape(m).to(torch.float64)
    toep = torch.where((k >= 0) & (k < m), col[k.clamp(0, m - 1)], 0.0)
    cols = a.to(torch.float64).transpose(-1, -2) @ toep.T  # (..., B, n + m - 1)
    return cols.transpose(-1, -2).to(torch.int64)


def sub_limbs(a: torch.Tensor, b: torch.Tensor):
    """(a - b) mod 2^(16 n) limbwise and the borrow (1 iff a < b)."""
    n = a.shape[-2]
    limbs, cout = propagate(a + (LIMB_MASK - b) + const_limbs(_unit(n), a.device, a.dtype))
    return limbs, 1 - cout


def cond_sub_p(spec, t: torch.Tensor, extra: torch.Tensor) -> torch.Tensor:
    """Reduce t + extra * 2^(16n) < 2p into [0, p)."""
    key = ("comp_p", spec.p, spec.n, str(t.device), t.dtype)
    comp = _CONSTS.get(key)
    if comp is None:  # t - p computed as t + (2^16 - 1 - p_i) + [1 at limb 0]
        comp = LIMB_MASK - spec.p_limbs.astype(np.int64) + _unit(spec.n)
        comp = _CONSTS[key] = const_limbs(comp, t.device, t.dtype)
    diff, cout = propagate(t + comp)
    return torch.where((cout + extra > 0).unsqueeze(-2), diff, t)
