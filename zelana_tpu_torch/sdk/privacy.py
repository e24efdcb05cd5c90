"""Privacy note stack (mirror of sdk/privacy).

- Commitment = Poseidon(value, randomness, owner_pk) over BLS12-381 Fr
  (commitment.rs:63-85; note the deliberate reference quirk that the
  commitment tree field is BLS12-381 while the proving circuits are BN254)
- Nullifier = Poseidon(0x4e554c4c "NULL", key, commitment, position)
  (nullifier.rs:84-105)
- nk derivation Poseidon("ZelanaNK", ask) (nullifier.rs:110-127)
- note encryption: X25519 ECDH + HKDF("zelana-note-v1") + ChaCha20-Poly1305
  (encryption.rs:1-33)
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Optional

from ..hashes.poseidon import bls12_381_config, poseidon_hash
from . import aead

_CFG = None


def _cfg():
    global _CFG
    if _CFG is None:
        _CFG = bls12_381_config()
    return _CFG


def _fle(b: bytes) -> int:
    return int.from_bytes(b, "little") % _cfg().modulus


def _to32(v: int) -> bytes:
    return int(v).to_bytes(32, "little")


NULL_DOMAIN = 0x4E554C4C  # "NULL"
NK_DOMAIN = b"ZelanaNK" + b"\x00" * 24


@dataclass
class Note:
    value: int
    randomness: bytes  # 32
    owner_pk: bytes  # 32

    def commitment(self) -> bytes:
        return commit(self.value, self.randomness, self.owner_pk)

    def to_json(self) -> str:
        return json.dumps({
            "value": self.value,
            "randomness": self.randomness.hex(),
            "owner_pk": self.owner_pk.hex(),
        })

    @classmethod
    def from_json(cls, s: str) -> "Note":
        d = json.loads(s)
        # int() accepts both encodings: our own integer and the TS SDK's
        # decimal string (JS must string-encode u64 values -- JSON numbers
        # are float64 there and would round at 2^53)
        return cls(int(d["value"]), bytes.fromhex(d["randomness"]),
                   bytes.fromhex(d["owner_pk"]))


def commit(value: int, randomness: bytes, owner_pk: bytes) -> bytes:
    h = poseidon_hash(_cfg(), [value, _fle(randomness), _fle(owner_pk)])
    return _to32(h)


def commit_extended(value: int, randomness: bytes, owner_pk: bytes,
                    asset_id: bytes) -> bytes:
    h = poseidon_hash(
        _cfg(), [value, _fle(randomness), _fle(owner_pk), _fle(asset_id)]
    )
    return _to32(h)


def random_blinding() -> bytes:
    return os.urandom(32)


def derive_nullifier(spending_key: bytes, commitment: bytes,
                     position: int) -> bytes:
    h = poseidon_hash(
        _cfg(), [NULL_DOMAIN, _fle(spending_key), _fle(commitment), position]
    )
    return _to32(h)


def derive_nk(spending_key: bytes) -> bytes:
    h = poseidon_hash(_cfg(), [_fle(NK_DOMAIN), _fle(spending_key)])
    return _to32(h)


# --------------------------------------------------------------------------
# note encryption (encryption.rs)
# --------------------------------------------------------------------------

NOTE_HKDF_INFO = b"zelana-note-v1"


def encrypt_note(note: Note, recipient_x25519_pk: bytes) -> bytes:
    """ephemeral-key ECIES: [eph_pk(32) | nonce(12) | ciphertext+tag]."""
    eph_sk, eph_pk = aead.x25519_keypair()
    shared = aead.x25519(eph_sk, recipient_x25519_pk)
    key = aead.hkdf_sha256(shared, NOTE_HKDF_INFO)
    nonce = os.urandom(12)
    ct = aead.chacha20poly1305_encrypt(key, nonce, note.to_json().encode())
    return eph_pk + nonce + ct


def decrypt_note(blob: bytes, recipient_x25519_sk: bytes) -> Optional[Note]:
    if len(blob) < 32 + 12 + 16:
        return None
    eph_pk, nonce, ct = blob[:32], blob[32:44], blob[44:]
    shared = aead.x25519(recipient_x25519_sk, eph_pk)
    key = aead.hkdf_sha256(shared, NOTE_HKDF_INFO)
    try:
        pt = aead.chacha20poly1305_decrypt(key, nonce, ct)
    except ValueError:
        return None
    return Note.from_json(pt.decode())
