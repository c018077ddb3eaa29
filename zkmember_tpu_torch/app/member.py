"""Member domain model: PII record, deterministic byte encoding, mock data.

Byte-for-byte reimplementation of the reference's member encoding
(src/member.rs:61-83): id bytes || email bytes ||
be-i64(join timestamp) || end-date tag byte (1 + be-i64 | 0) || padding tag
byte (1 + zero bytes | 0).  JSON (de)serialization mirrors member.rs:90-150
(rfc3339 dates; padding round-trips only its length, as in the reference).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from datetime import datetime, timezone


def _now() -> datetime:
    return datetime.now(timezone.utc)


@dataclass
class Member:
    id: str = ""
    email: str = ""
    join_date: datetime = field(default_factory=_now)
    end_date: datetime | None = None
    padding: bytes | None = None

    @classmethod
    def new(cls, id: str, email: str, end_date: datetime | None = None) -> "Member":
        return cls(id=id, email=email, join_date=_now(), end_date=end_date)

    @classmethod
    def new_with_padding(
        cls, id: str, email: str, end_date: datetime | None, pad: int
    ) -> "Member":
        return cls(id=id, email=email, join_date=_now(), end_date=end_date, padding=b"\x00" * pad)

    @classmethod
    def default(cls, join_date: datetime | None = None) -> "Member":
        """The tree-padding leaf (member.rs:23-33): empty id/email, now()."""
        return cls(id="", email="", join_date=join_date or _now())

    def to_bytes(self) -> bytes:
        """Deterministic encoding — the leaf hash preimage (member.rs:61-83)."""
        out = bytearray()
        out += self.id.encode()
        out += self.email.encode()
        out += int(self.join_date.timestamp()).to_bytes(8, "big", signed=True)
        if self.end_date is not None:
            out += b"\x01"
            out += int(self.end_date.timestamp()).to_bytes(8, "big", signed=True)
        else:
            out += b"\x00"
        if self.padding is not None:
            out += b"\x01"
            out += self.padding
        else:
            out += b"\x00"
        return bytes(out)

    def hash(self, leaf_params) -> int:
        """Leaf digest = Pedersen LeafHash of the byte encoding (member.rs:85-87)."""
        from zkmember_tpu_torch.hash import pedersen as ph

        return ph.hash_bytes_host(leaf_params, self.to_bytes()).v

    @staticmethod
    def hash_batch(leaf_params, members: list["Member"], device=None) -> list[int]:
        """[m.hash(leaf_params) for m in members] as ONE tiled device hash
        (``hash.pedersen.hash_bits_tiled``) on ``device.resolve(device)``:
        the card unless the caller passes "cpu"."""
        import numpy as np

        from zkmember_tpu_torch import device as devices
        from zkmember_tpu_torch.fields import spec as fs
        from zkmember_tpu_torch.hash import pedersen as ph

        if not members:
            return []
        cap = leaf_params.window.capacity_bits
        bits = np.stack([ph.bytes_to_bits(m.to_bytes(), cap) for m in members])
        return fs.limbs_to_ints(ph.hash_bits_tiled(leaf_params, bits, devices.resolve(device)))

    # -- serde-JSON mirror (member.rs:90-150) -------------------------------
    def to_json(self) -> str:
        return json.dumps(
            {
                "id": self.id,
                "email": self.email,
                "join_date": self.join_date.isoformat(),
                "end_date": self.end_date.isoformat() if self.end_date else None,
                "padding": "0" * (len(self.padding) if self.padding else 0),
            }
        )

    @classmethod
    def from_json(cls, s: str) -> "Member":
        d = json.loads(s)
        return cls(
            id=d["id"],
            email=d["email"],
            join_date=datetime.fromisoformat(d["join_date"]),
            end_date=datetime.fromisoformat(d["end_date"]) if d.get("end_date") else None,
            padding=b"\x00" * len(d["padding"]) if d.get("padding") else None,
        )


def generate_members(amount: int) -> list[Member]:
    """Mock registrar: ids "1".."{n}", emails "{i}@usc.edu" (member.rs:152-160)."""
    return [Member.new(str(i), f"{i}@usc.edu") for i in range(1, amount + 1)]


def generate_members_with_padding(amount: int, padding: int) -> list[Member]:
    return [
        Member.new_with_padding(str(i), f"{i}@usc.edu", None, padding)
        for i in range(1, amount + 1)
    ]
