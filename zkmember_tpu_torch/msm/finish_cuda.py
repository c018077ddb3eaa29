"""The Straus MSM's finish (tail reduction plus Horner join), a CUDA kernel
and its plain version.

Replaces what the reference runs as XLA scans after its Pallas K1,
``zkmember_tpu/msm/straus.py::tree_reduce_lanes`` and ``::horner_join``.
The kernel is ``csrc/msm_finish.cu``: the tail adds each window's NT lanes
up chunk by chunk (``TAIL_CHUNK``), one lane group an addition,
across the whole card; the join runs each row's chain of doublings and
additions, each wave's products split over lane groups of their own.  Two
launches per MSM: the join, and the tail beside it (``msm_finish_in_turn``
runs the tail to its end first, for the two kernels' times apart).

``msm_finish(ops, S)`` takes K1's window sums, coordinates of
``(W, [R,] n, NT)`` int32 planes (most significant window first, NT a power
of two), and returns the MSM as projective coordinates ``([R,] n, 1)``.
The kernel has the variants of K1: Fp at n = 24 and 48, Fp2 at n = 24.  A
CUDA tensor goes to the kernel; a CPU tensor takes ``msm_finish_plain``,
which runs the kernel's point operations in its order, so the two agree
limb for limb.
"""

from __future__ import annotations

import ctypes

import torch

from zkmember_tpu_torch import kernels
from zkmember_tpu_torch.curves import device as cdv
from zkmember_tpu_torch.msm import select_reduce_cuda

WINDOW_BITS = 4
TAIL_CHUNK, TAIL_KEEP = 64, 8  # msm_finish.cu: 2 kTailGroups, kTailKeep


def _map(f, c):
    return tuple(_map(f, ci) for ci in c) if isinstance(c, tuple) else f(c)


def _first(c):
    while isinstance(c, tuple):
        c = c[0]
    return c


def tail_plain(ops, S):
    """Window sums, coords (..., n, NT) -> (..., n, 1), as the kernel's tail
    adds them: while a window is wider than TAIL_CHUNK lanes, each chunk is
    halved contiguously (lane i += lane i + h) down to TAIL_KEEP lanes and
    the chunks' partial sums, chunk by chunk, are the next stage's lanes; a
    window no wider than a chunk is halved down to one lane."""
    B = _first(S[0]).shape[-1]
    while B > 1:
        c = min(TAIL_CHUNK, B)
        stop = 1 if B <= TAIL_CHUNK else TAIL_KEEP
        # (..., n, B) -> (..., B / c, n, c): the chunks as a batch axis
        P = tuple(_map(lambda x: x.reshape(x.shape[:-1] + (B // c, c)).transpose(-3, -2), x)
                  for x in S)
        while c > stop:
            h = c // 2
            P = cdv.swp_add(ops, tuple(_map(lambda x: x[..., :h], x) for x in P),
                            tuple(_map(lambda x: x[..., h:], x) for x in P))
            c = h
        # (..., B / chunk, n, stop) -> (..., n, B / chunk * stop), chunk-major
        S = tuple(_map(lambda x: x.transpose(-3, -2).reshape(x.shape[:-3] + (x.shape[-2], -1))
                       .contiguous(), x) for x in P)
        B = _first(S[0]).shape[-1]
    return S


def join_plain(ops, S):
    """Window sums, coords (W, ..., n, 1) most significant first -> one
    point, as the kernel's join: acc = S_0, then for each later window four
    doublings (RCB15 Alg. 9) and acc + S_w."""
    W = _first(S[0]).shape[0]
    acc = tuple(_map(lambda c: c[0], x) for x in S)
    for w in range(1, W):
        for _ in range(WINDOW_BITS):
            acc = cdv.swp_double(ops, acc)
        acc = cdv.swp_add(ops, acc, tuple(_map(lambda c: c[w], x) for x in S))
    return acc


def msm_finish_plain(ops, S):
    """Plain PyTorch version on any device."""
    return join_plain(ops, tail_plain(ops, S))


def tail_scratch(WR: int, NT: int) -> tuple[int, int]:
    """Point records and counters the kernel's tail needs for WR windows of
    NT lanes: one record a partial sum handed to a later stage, one counter
    a chunk of those."""
    records = counters = 0
    w = NT
    while w > TAIL_CHUNK:
        w = w // TAIL_CHUNK * TAIL_KEEP
        records += WR * w
        counters += WR * (w // min(TAIL_CHUNK, w))
    return records, counters


def _planes(S):
    return [c for coord in S for c in (coord if isinstance(coord, tuple) else (coord,))]


def msm_finish_cuda(ops, S):
    """Launch the kernel (two launches: the join, then the tail beside it)."""
    return _launch(ops, S, in_turn=False)


def msm_finish_in_turn(ops, S):
    """The kernel with its tail run to its end before the join starts: the
    same output, and the two kernels' device times apart under a profiler."""
    return _launch(ops, S, in_turn=True)


def _launch(ops, S, in_turn: bool):
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

    records, counters = tail_scratch(W * R, NT)
    record = len(planes) * n // 2  # words of a point record: 3 coordinates, n/2 a component
    scratch = torch.empty(max(records, 1) * record, dtype=torch.int32, device=dev)
    # the tail's counters, then a ready flag a window sum, the count of the
    # tail's chunks taken and of its blocks ended
    count = torch.zeros(counters + W * R + 2, dtype=torch.int32, device=dev)
    sums = torch.empty(W * R * record, dtype=torch.int32, device=dev)
    outs = empty(R, n, 1)

    def ptrs(ts):
        return (ctypes.c_void_p * 6)(*([t.data_ptr() for t in ts] + [0] * (6 - len(ts))))

    p_words, np0 = kernels.field_consts(spec)
    rc = kernels.launch(
        kernels.library().zk_msm_finish, dev, n, int(fp2), ptrs(planes), ptrs(outs),
        scratch.data_ptr(), count.data_ptr(), sums.data_ptr(), count[counters:].data_ptr(), W, R,
        NT, TAIL_CHUNK, TAIL_KEEP, p_words, np0, int(b3[0]), int(b3[1]), int(in_turn))
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
