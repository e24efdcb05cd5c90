"""K-of-N threshold crypto for the encrypted mempool (mirror of sdk/threshold).

- Shamir secret sharing over GF(256), byte-wise, AES polynomial 0x11b
  (shares.rs:47-70)
- committee with X25519-encrypted share distribution (committee.rs:186-210)
- ChaCha20-Poly1305 blob encryption, EncryptedMempool blind ordering and a
  DecryptionCoordinator (encrypted_tx.rs:59-278)
"""

from __future__ import annotations

import hashlib
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from . import aead

# ---------------------------------------------------------------------------
# GF(256) arithmetic (AES polynomial)
# ---------------------------------------------------------------------------


def _gf_mul(a: int, b: int) -> int:
    r = 0
    while b:
        if b & 1:
            r ^= a
        a <<= 1
        if a & 0x100:
            a ^= 0x11B
        b >>= 1
    return r


def _gf_pow(a: int, e: int) -> int:
    r = 1
    while e:
        if e & 1:
            r = _gf_mul(r, a)
        a = _gf_mul(a, a)
        e >>= 1
    return r


def _gf_inv(a: int) -> int:
    return _gf_pow(a, 254)


@dataclass
class Share:
    index: int  # x coordinate, 1..N
    data: bytes


def share_secret(secret: bytes, k: int, n: int,
                 rng=os.urandom) -> List[Share]:
    """Split a secret byte-wise: per byte a degree-(k-1) polynomial."""
    assert 1 <= k <= n <= 255
    coeffs = [rng(len(secret)) for _ in range(k - 1)]
    shares = []
    for x in range(1, n + 1):
        out = bytearray()
        for i, s_byte in enumerate(secret):
            y = s_byte
            xp = 1
            for c in coeffs:
                xp = _gf_mul(xp, x)
                y ^= _gf_mul(c[i], xp)
            out.append(y)
        shares.append(Share(x, bytes(out)))
    return shares


def reconstruct(shares: List[Share]) -> bytes:
    """Lagrange interpolation at x = 0."""
    assert shares
    length = len(shares[0].data)
    out = bytearray(length)
    for i, si in enumerate(shares):
        num, den = 1, 1
        for j, sj in enumerate(shares):
            if i == j:
                continue
            num = _gf_mul(num, sj.index)
            den = _gf_mul(den, si.index ^ sj.index)
        coeff = _gf_mul(num, _gf_inv(den))
        for b in range(length):
            out[b] ^= _gf_mul(si.data[b], coeff)
    return bytes(out)


# ---------------------------------------------------------------------------
# committee
# ---------------------------------------------------------------------------


@dataclass
class CommitteeMember:
    index: int
    x25519_pk: bytes
    _sk: Optional[bytes] = None  # local testing only


@dataclass
class Committee:
    threshold: int
    members: List[CommitteeMember]

    @classmethod
    def create_test(cls, k: int = 3, n: int = 5) -> Tuple["Committee", List[bytes]]:
        members, sks = [], []
        for i in range(1, n + 1):
            sk, pk = aead.x25519_keypair()
            members.append(CommitteeMember(i, pk, sk))
            sks.append(sk)
        return cls(k, members), sks

    def distribute(self, secret: bytes) -> Dict[int, bytes]:
        """Shamir-split and encrypt each share to its member's X25519 key."""
        shares = share_secret(secret, self.threshold, len(self.members))
        out = {}
        for member, share in zip(self.members, shares):
            eph_sk, eph_pk = aead.x25519_keypair()
            key = aead.hkdf_sha256(
                aead.x25519(eph_sk, member.x25519_pk), b"zelana-share-v1"
            )
            nonce = os.urandom(12)
            ct = aead.chacha20poly1305_encrypt(
                key, nonce, bytes([share.index]) + share.data
            )
            out[member.index] = eph_pk + nonce + ct
        return out

    @staticmethod
    def open_share(blob: bytes, member_sk: bytes) -> Share:
        eph_pk, nonce, ct = blob[:32], blob[32:44], blob[44:]
        key = aead.hkdf_sha256(
            aead.x25519(member_sk, eph_pk), b"zelana-share-v1"
        )
        pt = aead.chacha20poly1305_decrypt(key, nonce, ct)
        return Share(pt[0], pt[1:])


# ---------------------------------------------------------------------------
# encrypted mempool: blind ordering, then committee decryption
# ---------------------------------------------------------------------------


@dataclass
class EncryptedTx:
    tx_id: bytes
    ciphertext: bytes  # nonce | aead blob
    encrypted_shares: Dict[int, bytes]
    received_at: float = field(default_factory=time.time)


def encrypt_for_mempool(tx_bytes: bytes, committee: Committee) -> EncryptedTx:
    key = os.urandom(32)
    nonce = os.urandom(12)
    ct = aead.chacha20poly1305_encrypt(key, nonce, tx_bytes)
    return EncryptedTx(
        tx_id=hashlib.sha256(ct).digest()[:16],
        ciphertext=nonce + ct,
        encrypted_shares=committee.distribute(key),
    )


class EncryptedMempool:
    """Orders ciphertexts before anyone can read them (encrypted_tx.rs)."""

    def __init__(self):
        self.queue: List[EncryptedTx] = []

    def submit(self, etx: EncryptedTx):
        self.queue.append(etx)

    def ordered(self) -> List[EncryptedTx]:
        return sorted(self.queue, key=lambda e: (e.received_at, e.tx_id))


class DecryptionCoordinator:
    def __init__(self, committee: Committee):
        self.committee = committee

    def decrypt(self, etx: EncryptedTx, member_sks: Dict[int, bytes]) -> bytes:
        shares = []
        for idx, sk in member_sks.items():
            blob = etx.encrypted_shares.get(idx)
            if blob is None:
                continue
            shares.append(Committee.open_share(blob, sk))
            if len(shares) >= self.committee.threshold:
                break
        if len(shares) < self.committee.threshold:
            raise ValueError("not enough shares")
        key = reconstruct(shares)
        nonce, ct = etx.ciphertext[:12], etx.ciphertext[12:]
        return aead.chacha20poly1305_decrypt(key, nonce, ct)
