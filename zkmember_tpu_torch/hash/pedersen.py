"""Pedersen CRH with twisted-Edwards point compression, on the host and batched on a device.

Counterpart of zkmember_tpu.hash.pedersen.  Parity with
ark-crypto-primitives' ``PedersenCRHCompressor<_, TECompressor, W>``:

  * parameters = per-window generator power tables: table[w][j] = 2^j * g_w,
    w < NUM_WINDOWS, j < WINDOW_SIZE, g_w sampled from an RNG;
  * evaluate(bytes): zero-pad input bytes to the window capacity, decompose
    into bits LSB-first per byte, and add the table point of every set bit;
  * compress: the affine x-coordinate of the result (TECompressor).

The device hash is batched over messages: each window's WINDOW_SIZE bits
form one digit, whose point [digit] g_w is read from a per-window digit
table; log2 rounds of unified twisted-Edwards additions sum the windows;
one batched inversion gives the affine x.  Every field product is a
stacked batch-major Montgomery product (kernel K3 on the card, its plain
version on the CPU), through ``curves.device``'s TE ops.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from zkmember_tpu_torch.curves import device as cdv
from zkmember_tpu_torch.fields import device as dv
from zkmember_tpu_torch.fields import spec as fs


@dataclass(frozen=True)
class Window:
    """Pedersen window shape (mirrors pedersen::Window consts)."""

    window_size: int
    num_windows: int

    @property
    def capacity_bits(self) -> int:
        return self.window_size * self.num_windows

    @property
    def capacity_bytes(self) -> int:
        return self.capacity_bits // 8


# the three window configurations the reference instantiates
TWO_TO_ONE_WINDOW_381 = Window(4, 128)  # 512 bits  (2 x 32-byte digests)
LEAF_WINDOW_381 = Window(4, 144)  # 576 bits  (72-byte leaf capacity)
WINDOW_761 = Window(4, 192)  # 768 bits  (2 x 48-byte digests / leaves)


class DeviceTables(NamedTuple):
    """A PedersenParams' digit tables and curve constants on one device."""

    F: dv.FpOps
    consts: cdv.TEConsts
    digit_x: torch.Tensor  # (num_windows, 2^window_size, n) int32 Montgomery limbs
    digit_y: torch.Tensor
    digit_t: torch.Tensor  # x y (extended coordinate, Z = 1)


class PedersenParams:
    """Sampled generator tables for one (curve, window) configuration.

    Keeps, as host arrays (construction needs no device):
      * the per-bit table as host affine points (bit-major: the point for
        absolute bit k is 2^(k % WINDOW_SIZE) * g_(k // WINDOW_SIZE)),
        consumed by the host hash and the R1CS gadget layer, and as
        (capacity_bits, n) Montgomery planes ``table_x`` / ``table_y``;
      * the per-window digit tables digit_table[w][v] = [v] g_w as
        (num_windows, 2^WINDOW_SIZE, n) Montgomery limbs (``digit_x``,
        ``digit_y``, ``digit_t`` = x y): the reference's window layout is
        powers-of-two multiples of one generator per window, so a window
        collapses to one table lookup;
      * the curve constants (``consts``) and the base field's spec.
    ``device_tables(device)`` ships the digit tables once per device.
    """

    def __init__(self, curve, window: Window, rng):
        self.curve = curve  # host TECurve
        self.window = window
        field = curve.field
        pts = []
        gens = []
        for _ in range(window.num_windows):
            g = _sample_group_element(curve, rng)
            gens.append(g)
            for _ in range(window.window_size):
                pts.append(g)
                g = curve.double(g)
        self.table_host = pts  # list of (x, y) host field elements, bit-major
        spec = self.spec = _spec_for_modulus(field.p)
        self.table_x = spec.to_mont_host([pt[0].v for pt in pts])  # (capacity_bits, n)
        self.table_y = spec.to_mont_host([pt[1].v for pt in pts])
        self.consts = cdv.TEConsts(spec.mont_scalar(curve.a.v), spec.mont_scalar(curve.d.v))
        T = 1 << window.window_size
        dig_pts = []
        for g in gens:
            acc = curve.identity()
            for _ in range(T):
                dig_pts.append(acc)
                acc = curve.add(acc, g)
        shape = (window.num_windows, T, spec.n)
        self.digit_x = spec.to_mont_host([q[0].v for q in dig_pts]).reshape(shape)
        self.digit_y = spec.to_mont_host([q[1].v for q in dig_pts]).reshape(shape)
        self.digit_t = spec.to_mont_host(
            [q[0].v * q[1].v % field.p for q in dig_pts]).reshape(shape)
        self._device_tables: dict = {}

    def device_tables(self, device) -> DeviceTables:
        """The digit tables and constants on `device`, shipped once."""
        dev = torch.device(device)
        key = str(dev)
        if key not in self._device_tables:
            def ship(a):
                return torch.as_tensor(a.astype(np.int32), device=dev)

            self._device_tables[key] = DeviceTables(
                dv.FpOps(self.spec, dev), self.consts, ship(self.digit_x),
                ship(self.digit_y), ship(self.digit_t))
        return self._device_tables[key]


def _spec_for_modulus(p: int) -> fs.FieldSpec:
    for spec in (fs.BLS_FR, fs.BLS_FQ, fs.BW6_FR, fs.BW6_FQ):
        if spec.p == p:
            return spec
    raise ValueError(f"no device field spec for modulus of {p.bit_length()} bits")


def _sample_group_element(curve, rng) -> tuple:
    """Uniform-ish prime-order-subgroup point: random scalar times generator.

    The reference samples params from `ark_std::test_rng()`
    (src/commitments/pedersen381/mod.rs:24-25); our RNG
    stream is the framework's own deterministic stream (utils.rng).
    """
    while True:
        k = rng.randrange(1, curve.order if curve.order else curve.field.p)
        g = curve.mul(k, curve.generator)
        if not curve.is_identity(g):
            return g


def bytes_to_bits(data: bytes, nbits: int) -> np.ndarray:
    """LSB-first-per-byte bit decomposition, zero-padded to nbits."""
    if len(data) * 8 > nbits:
        raise ValueError(f"{len(data)} bytes exceed {nbits} bits")
    out = np.zeros(nbits, dtype=np.uint32)
    out[: len(data) * 8] = np.unpackbits(np.frombuffer(data, np.uint8), bitorder="little")
    return out


# ---------------------------------------------------------------------------
# host evaluation (oracle / small inputs)
# ---------------------------------------------------------------------------


def hash_bytes_host(params: PedersenParams, data: bytes):
    """Host Pedersen hash -> compressed digest (host field element)."""
    cap = params.window.capacity_bits
    if len(data) > params.window.capacity_bytes:
        raise ValueError(
            f"input of {len(data)} bytes exceeds window capacity "
            f"{params.window.capacity_bytes}"
        )
    bits = bytes_to_bits(data, cap)
    curve = params.curve
    acc = curve.identity()
    for k in range(cap):
        if bits[k]:
            acc = curve.add(acc, params.table_host[k])
    return acc[0]  # TECompressor: affine x-coordinate


def two_to_one_host(params: PedersenParams, left: bytes, right: bytes):
    """TwoToOneCRH::evaluate — concatenated child digests, same window eval."""
    return hash_bytes_host(params, left + right)


# ---------------------------------------------------------------------------
# device evaluation (batched)
# ---------------------------------------------------------------------------


def hash_bits_device(params: PedersenParams, bits: torch.Tensor) -> torch.Tensor:
    """Batched Pedersen hash of (B, capacity_bits) 0/1 integer rows on a
    device (the tables are shipped there): canonical (B, n) int32 digest
    limbs, the affine x-coordinates.

    The reference's ``_hash_kernel``: per-window digits (LSB-first in the
    window), one table point a (row, window) by an exact index gather
    (the reference's one-hot f32 einsum selects the same entries), the
    window axis padded to a power of two with the identity (0, 1, 0, 1)
    after the real windows, log2 rounds of te_add over even/odd columns,
    te_to_affine, from_mont."""
    tables = params.device_tables(bits.device)
    F, spec = tables.F, params.spec
    B, cap = bits.shape
    nw, T = tables.digit_x.shape[:2]
    ws = params.window.window_size
    if cap != nw * ws:
        raise ValueError(f"expected (B, {nw * ws}) bit rows, got {tuple(bits.shape)}")
    weights = 1 << torch.arange(ws, dtype=torch.int64, device=bits.device)
    digits = (bits.reshape(B, nw, ws).to(torch.int64) * weights).sum(-1)  # (B, nw)
    windows = torch.arange(nw, device=bits.device)
    X, Y, Tc = (tbl[windows, digits] for tbl in (tables.digit_x, tables.digit_y,
                                                  tables.digit_t))
    L = 1 << (nw - 1).bit_length()
    if L != nw:
        zero = F.zeros((B, L - nw))
        X = torch.cat([X, zero], dim=1)
        Tc = torch.cat([Tc, zero], dim=1)
        Y = torch.cat([Y, F.ones((B, L - nw))], dim=1)
    P = (X, Y, Tc, F.ones((B, L)))
    while L > 1:
        even = tuple(c[:, 0::2] for c in P)
        odd = tuple(c[:, 1::2] for c in P)
        P = cdv.te_add(F, tables.consts, even, odd)
        L //= 2
    x, _ = cdv.te_to_affine(F, tuple(c[:, 0] for c in P))
    return dv.from_mont(spec, x)


def hash_tile(device) -> int:
    """Rows a device hash call takes at once.  Eager PyTorch compiles nothing
    per shape, so the tile only bounds memory: on the card one tile holds a
    1,024-row level whole (the widest te_add wave is then (5, 1024, 128, n)
    rows); the CPU's plain products keep int64 temporaries, so less."""
    return 1024 if torch.device(device).type == "cuda" else 64


def hash_bits_tiled(params: PedersenParams, bits_np: np.ndarray, device,
                    tile: int | None = None) -> np.ndarray:
    """Hash (B, capacity_bits) host bit rows on `device`, `tile` rows a
    call (default ``hash_tile(device)``; the last call takes the rest).
    Returns (B, n) canonical uint32 limbs."""
    tile = tile or hash_tile(device)
    outs = [
        hash_bits_device(params, torch.as_tensor(
            np.asarray(bits_np[s : s + tile]).astype(np.int32), device=device)).cpu()
        for s in range(0, bits_np.shape[0], tile)
    ]
    return torch.cat(outs).numpy().astype(np.uint32)


def digests_to_bits_device(spec: fs.FieldSpec, digests: torch.Tensor, nbits: int):
    """Canonical (B, n) limb digests -> (B, nbits) int32 bit rows on their
    device: the little-endian bit order of the value, zero-padded (what
    bytes_to_bits gives for its little-endian bytes)."""
    want = (nbits + fs.LIMB_BITS - 1) // fs.LIMB_BITS
    d = digests
    if want > d.shape[-1]:
        d = torch.nn.functional.pad(d, (0, want - d.shape[-1]))
    shifts = torch.arange(fs.LIMB_BITS, dtype=d.dtype, device=d.device)
    bits = (d[..., :want, None] >> shifts) & 1
    return bits.reshape(d.shape[:-1] + (want * fs.LIMB_BITS,))[..., :nbits].to(torch.int32)


def limbs_to_bits_np(limbs: np.ndarray, nbits: int) -> np.ndarray:
    """(B, n) canonical 16-bit-limb rows -> (B, nbits) uint32 host bit rows
    (little-endian bit order of the value, zero-padded)."""
    limbs = np.asarray(limbs)
    want = (nbits + fs.LIMB_BITS - 1) // fs.LIMB_BITS
    if want > limbs.shape[-1]:
        limbs = np.pad(limbs, [(0, 0)] * (limbs.ndim - 1) + [(0, want - limbs.shape[-1])])
    shifts = np.arange(fs.LIMB_BITS, dtype=np.uint32)
    bits = (limbs[..., :want, None].astype(np.uint32) >> shifts) & 1
    return bits.reshape(limbs.shape[:-1] + (want * fs.LIMB_BITS,))[..., :nbits]


def two_to_one_tiled(params: PedersenParams, left_limbs: np.ndarray, right_limbs: np.ndarray,
                     device, tile: int | None = None) -> np.ndarray:
    """Tiled TwoToOne hash over canonical numpy limb digests (a tree level)."""
    half = params.window.capacity_bits // 2
    bits = np.concatenate(
        [limbs_to_bits_np(left_limbs, half), limbs_to_bits_np(right_limbs, half)], axis=-1)
    return hash_bits_tiled(params, bits, device, tile)


def two_to_one_device(params: PedersenParams, left_digests: torch.Tensor,
                      right_digests: torch.Tensor) -> torch.Tensor:
    """Batched TwoToOne hash of canonical (B, n) limb digests on a device.

    A digest's byte width is the field's full limb width (32 B on the BLS
    stack, 48 B on BW6), exactly half the window capacity, as in the
    reference."""
    half = params.window.capacity_bits // 2
    lb = digests_to_bits_device(params.spec, left_digests, half)
    rb = digests_to_bits_device(params.spec, right_digests, half)
    return hash_bits_device(params, torch.cat([lb, rb], dim=-1))
