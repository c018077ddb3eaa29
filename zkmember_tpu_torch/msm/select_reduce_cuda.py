"""K1: fused Straus window select plus lane reduction, a CUDA kernel and its plain version.

Replaces the Pallas kernel ``zkmember_tpu/msm/pallas_msm.py::select_reduce``.
The kernel is ``csrc/select_reduce.cu``: one warp per (window, lane tile,
proof), every window, proof, row and tile on the grid, the P proofs of one
(window, tile) side by side; thread j of tile t sums its lanes
t*TL + k*T + j (k < L) in order into output lane t*T + j.  The narrow tail
reduction (``finish_cuda``) sums the B / L output lanes.  The table has one
layout, on every device: ``pack_records`` packs the limb planes into one
contiguous record per (entry, row, lane), so a thread's scattered select
reads whole records.  Bound: operations (one complete addition per lane
and window).

Tensors (int32, 16-bit limbs, Montgomery form):

    records (16, R, B, 3 C n/2)   [0..15] P_i, entry 0 the identity (0, 1, 0)
    digits  (W, [P,] R, B)        4-bit windows in [0, 16), most significant first
    out     (W, [P,] R, n, B/L)   per-thread projective window sums, per component

P is the reference's proof-batch axis: P proofs' digits against one shared
table.

``select_reduce_plain`` adds in exactly the kernel's order, so the two
agree limb for limb.  A CUDA tensor goes to the kernel; a CPU tensor takes
the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from zkmember_tpu_torch import kernels
from zkmember_tpu_torch.curves import device as cdv

WARP = 32
LANES_PER_THREAD = 16


def tile_shape(B: int) -> tuple[int, int]:
    """(threads T, lanes per thread L) of one tile of B lanes."""
    T = min(WARP, B)
    return T, max(1, min(LANES_PER_THREAD, B // T))


def _components(coord):
    return list(coord) if isinstance(coord, tuple) else [coord]


def _rebuild(flat, fp2: bool):
    if fp2:
        return tuple((flat[2 * i], flat[2 * i + 1]) for i in range(3))
    return tuple(flat)


def _map(f, c):
    if isinstance(c, tuple):
        return tuple(_map(f, ci) for ci in c)
    return f(c)


def select_reduce_plain(ops, records, digits):
    """Plain PyTorch version on any device (same add order as the kernel).
    Digits (W, P, R, B) run as (W P, R, B): each (window, proof) pair is
    one more window against the shared table."""
    if digits.ndim == 4:
        W, P = digits.shape[:2]
        S = select_reduce_plain(ops, records, digits.reshape((W * P,) + digits.shape[2:]))
        return tuple(_map(lambda c: c.reshape((W, P) + c.shape[1:]), x) for x in S)
    tab = unpack_records(records, isinstance(ops.b3, tuple))
    R, n, B = _components(tab[0])[0].shape[1:]
    W = digits.shape[0]
    T, L = tile_shape(B)
    tiles = B // (T * L)
    if tiles * T * L != B:
        raise ValueError(f"{B} lanes do not split into tiles of {T}x{L}")
    idx = digits.long().unsqueeze(-2).expand(W, R, n, B)

    def select(c):
        sel = torch.gather(c, 0, idx)  # (W, R, n, B)
        return sel.reshape(W, R, n, tiles, L, T).permute(0, 1, 3, 4, 2, 5)

    P = tuple(_map(select, c) for c in tab)  # (W, R, tiles, L, n, T)
    acc = tuple(_map(lambda c: c[:, :, :, 0], x) for x in P)
    for k in range(1, L):
        acc = cdv.swp_add(ops, acc, tuple(_map(lambda c: c[:, :, :, k], x) for x in P))
    # (W, R, tiles, n, T) -> (W, R, n, B / L)
    return tuple(_map(lambda c: c.permute(0, 1, 3, 2, 4).reshape(W, R, n, tiles * T), x)
                 for x in acc)


# The kernels' variants: (limbs n, Fp2) -> the suffix of their launch counts.
# Fp at n = 24 (BLS12-381 G1) and n = 48 (BW6-761 G1 and G2), Fp2 at n = 24
# (BLS12-381 G2, u^2 = -1).
VARIANTS = {(24, False): "fp", (48, False): "fp48", (24, True): "fp2"}


def kernel_consts(ops):
    """(fp2, base field spec, (b3c0, b3c1)) of a curve's ops for the kernels."""
    fp2 = isinstance(ops.b3, tuple)
    spec = ops.F.spec.base if fp2 else ops.F.spec
    if fp2 and ops.F.spec.nonresidue != spec.p - 1:
        raise ValueError("the Fp2 kernel assumes u^2 = -1 (BLS12-381 G2)")
    b3 = ops.b3 if fp2 else (ops.b3, 0)
    return fp2, spec, b3


def variant(kernel: str, fp2: bool, n: int) -> str:
    """The launch-count name of `kernel` for a field of n limbs, or a
    ValueError for a variant that is not built."""
    suffix = VARIANTS.get((n, fp2))
    if suffix is None:
        raise ValueError(f"{kernel} is built for n = 24 (Fp, Fp2) and n = 48 (Fp), "
                         f"not {'Fp2' if fp2 else 'Fp'} at n = {n}")
    return f"{kernel}_{suffix}"


def pack_records(tab):
    """The table's layout: coords (16, [R,] n, B) -> (16, R, B, 3 C n/2)
    int32, each lane's entry one contiguous record of words lo | hi << 16
    (x0 [x1] y0 [y1] z0 [z1]); a table without a row axis gets R = 1."""
    planes = [c for coord in tab for c in _components(coord)]
    if planes[0].ndim == 3:
        planes = [p[:, None] for p in planes]
    words = [p[:, :, 0::2] | (p[:, :, 1::2] << 16) for p in planes]  # (16, R, n/2, B)
    return torch.cat(words, dim=2).transpose(2, 3).contiguous()


def unpack_records(records, fp2: bool):
    """``pack_records``' inverse: records -> coords (16, R, n, B)."""
    planes = []
    for w in records.chunk(6 if fp2 else 3, dim=-1):  # (16, R, B, n/2) each
        w = w.transpose(2, 3)
        planes.append(torch.stack([w & 0xFFFF, (w >> 16) & 0xFFFF], 3).flatten(2, 3))
    return _rebuild(planes, fp2)


def select_reduce_cuda(ops, records, digits):
    """Launch the CUDA kernel (one launch for all windows, proofs and rows)."""
    fp2, spec, b3 = kernel_consts(ops)
    n, C = spec.n, 6 if fp2 else 3
    name = variant("select_reduce", fp2, n)
    shape = tuple(records.shape)
    if len(shape) != 4 or shape[0] != 16 or shape[3] != C * n // 2:
        raise ValueError(f"records must be (16, R, B, {C * n // 2}), got {shape}")
    _, R, B, _ = shape
    batched = digits.ndim == 4
    W, P = digits.shape[0], digits.shape[1] if batched else 1
    T, L = tile_shape(B)
    if T != WARP or B % (T * L):
        raise ValueError(f"the kernel needs whole tiles of {WARP} threads x {L} lanes, got {B} lanes")
    dev = records.device
    for p in (records, digits):
        if not p.is_cuda or p.device != dev or p.dtype != torch.int32 or not p.is_contiguous():
            raise ValueError("select_reduce needs contiguous int32 tensors on one CUDA device")
    if tuple(digits.shape) != ((W, P, R, B) if batched else (W, R, B)):
        raise ValueError(f"digits must be (W, [P,] {R}, {B}), got {tuple(digits.shape)}")
    lead = (W, P) if batched else (W,)
    outs = [torch.empty(lead + (R, n, B // L), dtype=torch.int32, device=dev) for _ in range(C)]
    out_ptrs = (ctypes.c_void_p * 6)(*([o.data_ptr() for o in outs] + [0] * (6 - len(outs))))
    p_words, np0 = kernels.field_consts(spec)
    rc = kernels.launch(kernels.library().zk_select_reduce, dev, n, int(fp2),
                        records.data_ptr(), digits.data_ptr(), out_ptrs, W, P, R, B, L, p_words,
                        np0, int(b3[0]), int(b3[1]))
    kernels.check(rc, name)
    kernels.LAUNCHES[name] += 1
    return _rebuild(outs, fp2)


def select_reduce(ops, records, digits):
    """Kernel for CUDA tensors, plain version for CPU tensors."""
    if digits.is_cuda:
        return select_reduce_cuda(ops, records, digits)
    return select_reduce_plain(ops, records, digits)
