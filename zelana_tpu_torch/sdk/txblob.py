"""Encrypted transaction blobs to the sequencer (mirror of sdk/txblob).

ECDH + HKDF("zelana-tx-v1") + ChaCha20-Poly1305 with a sender hint
(sdk/txblob/src/crypto.rs:23-31, types.rs).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

from . import aead

TX_HKDF_INFO = b"zelana-tx-v1"


@dataclass
class TxBlob:
    ephemeral_pk: bytes  # 32
    nonce: bytes  # 12
    ciphertext: bytes  # includes tag
    sender_hint: bytes = b""  # first 4 bytes of sender pubkey, optional

    def to_bytes(self) -> bytes:
        return (
            self.ephemeral_pk
            + self.nonce
            + len(self.sender_hint).to_bytes(1, "little")
            + self.sender_hint
            + self.ciphertext
        )

    @classmethod
    def from_bytes(cls, data: bytes) -> "TxBlob":
        eph, nonce = data[:32], data[32:44]
        hint_len = data[44]
        hint = data[45 : 45 + hint_len]
        return cls(eph, nonce, data[45 + hint_len :], hint)


def encrypt_tx(tx_bytes: bytes, sequencer_pk: bytes,
               sender_hint: bytes = b"") -> TxBlob:
    eph_sk, eph_pk = aead.x25519_keypair()
    key = aead.hkdf_sha256(aead.x25519(eph_sk, sequencer_pk), TX_HKDF_INFO)
    nonce = os.urandom(12)
    ct = aead.chacha20poly1305_encrypt(key, nonce, tx_bytes, aad=sender_hint)
    return TxBlob(eph_pk, nonce, ct, sender_hint)


def decrypt_tx(blob: TxBlob, sequencer_sk: bytes) -> Optional[bytes]:
    key = aead.hkdf_sha256(
        aead.x25519(sequencer_sk, blob.ephemeral_pk), TX_HKDF_INFO
    )
    try:
        return aead.chacha20poly1305_decrypt(
            key, blob.nonce, blob.ciphertext, aad=blob.sender_hint
        )
    except ValueError:
        return None
