"""Fiat-Shamir transcript over Blake2s (counterpart of zkmember_tpu.snark.transcript).

The reference's Marlin uses Blake2s for Fiat-Shamir; its exact ark-marlin
byte transcript is not reproduced, so the framework defines its own
deterministic one: absorb canonical little-endian encodings, squeeze field
elements by hashing a rolling counter and reducing 64 bytes mod r.  The
same absorbs give the same challenges in both packages, byte for byte.
"""

from __future__ import annotations

import hashlib


class Transcript:
    def __init__(self, label: bytes = b"zkmember_tpu"):
        self._state = hashlib.blake2s(label).digest()
        self._counter = 0

    def absorb_bytes(self, data: bytes):
        self._state = hashlib.blake2s(self._state + data).digest()

    def absorb_int(self, v: int, nbytes: int = 48):
        self.absorb_bytes(int(v).to_bytes(nbytes, "little", signed=False))

    def absorb_point(self, pt):
        """Absorb a host affine point (None = infinity)."""
        if pt is None:
            self.absorb_bytes(b"\x01" + b"\x00" * 95)
            return
        x, y = pt
        for coord in (x, y):
            if hasattr(coord, "coeffs"):  # extension element
                for c in coord.coeffs:
                    self.absorb_int(c.v, 96)
            else:
                self.absorb_int(coord.v, 96)

    def challenge(self, r: int) -> int:
        """Squeeze a field element of Z_r."""
        out = b""
        while len(out) < 64:
            out += hashlib.blake2s(
                self._state + self._counter.to_bytes(8, "little")
            ).digest()
            self._counter += 1
        self._state = hashlib.blake2s(self._state + out[:32]).digest()
        return int.from_bytes(out[:64], "little") % r
