"""Dual-key wallet (mirror of sdk/keypair).

One wallet holds an Ed25519 signing key (transparent transfers) and an
X25519 privacy key (note encryption, Zephyr sessions), with the reference's
human-readable signed message framing (sdk/keypair/src/lib.rs:17-40).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from ..sequencer import crypto as ed25519
from . import aead


@dataclass
class ZelanaKeypair:
    signing_seed: bytes  # 32 - ed25519
    privacy_sk: bytes  # 32 - x25519

    @classmethod
    def generate(cls) -> "ZelanaKeypair":
        return cls(os.urandom(32), os.urandom(32))

    @classmethod
    def from_seed(cls, seed: bytes) -> "ZelanaKeypair":
        import hashlib

        h = hashlib.sha512(seed).digest()
        return cls(h[:32], h[32:])

    @property
    def pubkey(self) -> bytes:
        _, _, pub = ed25519.secret_to_keypair(self.signing_seed)
        return pub

    @property
    def privacy_pk(self) -> bytes:
        return aead.x25519(self.privacy_sk)

    # -- human-readable signed message framing ----------------------------

    @staticmethod
    def frame_message(kind: str, fields: dict) -> bytes:
        lines = [f"Zelana {kind}"]
        for key in sorted(fields):
            lines.append(f"{key}: {fields[key]}")
        return "\n".join(lines).encode()

    def sign_message(self, kind: str, fields: dict) -> bytes:
        return ed25519.sign(self.signing_seed, self.frame_message(kind, fields))

    def sign_raw(self, message: bytes) -> bytes:
        return ed25519.sign(self.signing_seed, message)

    @staticmethod
    def verify_raw(pubkey: bytes, message: bytes, signature: bytes) -> bool:
        return ed25519.verify(pubkey, message, signature)
