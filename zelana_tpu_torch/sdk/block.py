"""Block header (sdk/block/src/lib.rs): 96 bytes, magic ``ZLNA``, version 1,
big-endian integer fields with a 2-byte reserved gap after the version."""

from __future__ import annotations

import struct
from dataclasses import dataclass

HEADER_MAGIC = b"ZLNA"
HEADER_VERSION = 1
HEADER_SIZE = 96

_FMT = ">4sHHQ32s32sIQI"  # magic, version, reserved, batch_id, prev, new,
# tx_count, open_at, flags -- exactly 96 bytes, no trailing padding
assert struct.calcsize(_FMT) == HEADER_SIZE


@dataclass
class BlockHeader:
    magic: bytes = HEADER_MAGIC
    hdr_version: int = HEADER_VERSION
    batch_id: int = 0
    prev_root: bytes = b"\x00" * 32
    new_root: bytes = b"\x00" * 32
    tx_count: int = 0
    open_at: int = 0
    flags: int = 0

    def to_bytes(self) -> bytes:
        return struct.pack(
            _FMT, self.magic, self.hdr_version, 0, self.batch_id,
            self.prev_root, self.new_root, self.tx_count, self.open_at,
            self.flags,
        )

    @classmethod
    def from_bytes(cls, data: bytes) -> "BlockHeader":
        if len(data) != HEADER_SIZE:
            raise ValueError(f"block header must be {HEADER_SIZE} bytes")
        magic, ver, _res, batch_id, prev, new, txc, open_at, flags = \
            struct.unpack(_FMT, data)
        if magic != HEADER_MAGIC:
            raise ValueError("bad block header magic")
        return cls(magic, ver, batch_id, prev, new, txc, open_at, flags)

    @classmethod
    def genesis(cls) -> "BlockHeader":
        return cls()
