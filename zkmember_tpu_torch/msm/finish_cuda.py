"""The Straus MSM's finish (narrow tail reduction plus Horner join), a CUDA
kernel and its plain version.

Replaces what the reference runs as XLA scans after its Pallas K1,
``zkmember_tpu/msm/straus.py::tree_reduce_lanes`` and ``::horner_join``.
The kernel is ``csrc/msm_finish.cu``: one block per (window, row) reduces
the window's lanes, then one warp per row runs the row's 5 W dependent
complete additions on K2's CIOS product, the independent products of each
addition on separate lanes.  Two launches per MSM, where the PyTorch
composition launches a few hundred kernels per complete addition.

``msm_finish(ops, S)`` takes K1's window sums, coordinates of
``(W, [R,] n, NT)`` int32 planes (most significant window first, NT a power
of two), and returns the MSM as projective coordinates ``([R,] n, 1)``.
The kernel has the variants of K1: Fp at n = 24 and 48, Fp2 at n = 24.  A
CUDA tensor goes to the kernel; a CPU tensor takes ``msm_finish_plain``,
``horner_join(tree_reduce_lanes(S))``, which adds in the kernel's order,
so the two agree limb for limb.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from zkmember_tpu_torch import kernels
from zkmember_tpu_torch.msm import select_reduce_cuda


def msm_finish_plain(ops, S):
    """Plain PyTorch version on any device."""
    from zkmember_tpu_torch.msm import straus

    return straus.horner_join(ops, straus.tree_reduce_lanes(ops, S))


def _planes(S):
    return [c for coord in S for c in (coord if isinstance(coord, tuple) else (coord,))]


def msm_finish_cuda(ops, S):
    """Launch the kernel (two launches: the tail, then the join)."""
    from zkmember_tpu_torch.msm import straus

    fp2, spec, b3 = select_reduce_cuda.kernel_consts(ops)
    name = select_reduce_cuda.variant("msm_finish", fp2, spec.n)
    planes = _planes(S)
    if len(planes) != (6 if fp2 else 3):
        raise ValueError("window sums must hold 3 coordinates (pairs for Fp2)")
    shape = tuple(planes[0].shape)
    squeeze = len(shape) == 3  # (W, n, NT): no row axis
    if squeeze:
        shape = (shape[0], 1) + shape[1:]
    if len(shape) != 4:
        raise ValueError(f"window sums must be (W, [R,] n, NT) planes, got {tuple(planes[0].shape)}")
    W, R, n, NT = shape
    if n != spec.n:
        raise ValueError(f"window sums of n = {n} limbs for a field of n = {spec.n}")
    if NT < 1 or NT & (NT - 1):
        raise ValueError(f"the lane count NT must be a power of two, got {NT}")
    if W < 1 or R < 1:
        raise ValueError(f"no window sums to join: W = {W}, R = {R}")
    dev = planes[0].device
    for p in planes:
        if not p.is_cuda or p.device != dev or p.dtype != torch.int32 or not p.is_contiguous():
            raise ValueError("msm_finish needs contiguous int32 planes on one CUDA device")
        if tuple(p.shape) != tuple(planes[0].shape):
            raise ValueError("window-sum planes differ in shape")

    def empty(*s):
        return [torch.empty(s, dtype=torch.int32, device=dev) for _ in planes]

    tail = straus.TAIL_WIDTH
    scratch = empty(W, R, n, NT // 2) if NT > tail else []
    sums, outs = empty(W, R, n, 1), empty(R, n, 1)

    def ptrs(ts):
        return (ctypes.c_void_p * 6)(*([t.data_ptr() for t in ts] + [0] * (6 - len(ts))))

    p_words, np0 = kernels.field_consts(spec)
    one_words = np.array([(spec.R >> (32 * i)) & 0xFFFFFFFF for i in range(n // 2)],
                         dtype=np.uint32)  # R mod p: the Montgomery form of 1
    rc = kernels.launch(
        kernels.library().zk_msm_finish, dev, n, int(fp2), ptrs(planes), ptrs(scratch),
        ptrs(sums), ptrs(outs), W, R, NT, tail, p_words, np0,
        one_words.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), int(b3[0]), int(b3[1]))
    kernels.check(rc, name)
    kernels.LAUNCHES[name] += 2
    if squeeze:
        outs = [o[0] for o in outs]
    if fp2:
        return tuple((outs[2 * i], outs[2 * i + 1]) for i in range(3))
    return tuple(outs)


def msm_finish(ops, S):
    """Kernel for CUDA tensors, plain version for CPU tensors."""
    if _planes(S)[0].is_cuda:
        return msm_finish_cuda(ops, S)
    return msm_finish_plain(ops, S)
