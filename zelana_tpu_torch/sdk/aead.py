"""X25519 + HKDF-SHA256 + ChaCha20-Poly1305 (RFC 7748 / 5869 / 8439).

The reference's client-edge crypto stack: note encryption
(sdk/privacy/src/encryption.rs: ECDH + HKDF("zelana-note-v1") + AEAD),
tx blobs (sdk/txblob/src/crypto.rs: "zelana-tx-v1"), and the Zephyr UDP
session keys (sdk/zephyr/src/keys.rs). Pure-Python implementations of the
standard primitives -- correctness-first; throughput-critical paths can drop
to native later.
"""

from __future__ import annotations

import hashlib
import hmac
import os
import struct

# ---------------------------------------------------------------------------
# X25519 (RFC 7748)
# ---------------------------------------------------------------------------

P25519 = 2**255 - 19
A24 = 121665


def _decode_scalar(k: bytes) -> int:
    a = bytearray(k)
    a[0] &= 248
    a[31] &= 127
    a[31] |= 64
    return int.from_bytes(bytes(a), "little")


def _decode_u(u: bytes) -> int:
    a = bytearray(u)
    a[31] &= 127
    return int.from_bytes(bytes(a), "little")


def x25519(k: bytes, u: bytes = None) -> bytes:
    """Scalar multiplication; u defaults to the base point 9."""
    scalar = _decode_scalar(k)
    x1 = _decode_u(u) if u is not None else 9
    x2, z2, x3, z3 = 1, 0, x1, 1
    swap = 0
    for t in range(254, -1, -1):
        k_t = (scalar >> t) & 1
        swap ^= k_t
        if swap:
            x2, x3 = x3, x2
            z2, z3 = z3, z2
        swap = k_t
        a = (x2 + z2) % P25519
        aa = a * a % P25519
        b = (x2 - z2) % P25519
        bb = b * b % P25519
        e = (aa - bb) % P25519
        c = (x3 + z3) % P25519
        d = (x3 - z3) % P25519
        da = d * a % P25519
        cb = c * b % P25519
        x3 = (da + cb) % P25519
        x3 = x3 * x3 % P25519
        z3 = (da - cb) % P25519
        z3 = x1 * (z3 * z3 % P25519) % P25519
        x2 = aa * bb % P25519
        z2 = e * (aa + A24 * e) % P25519
    if swap:
        x2, x3 = x3, x2
        z2, z3 = z3, z2
    return (x2 * pow(z2, P25519 - 2, P25519) % P25519).to_bytes(32, "little")


def x25519_keypair(seed: bytes = None):
    sk = seed or os.urandom(32)
    return sk, x25519(sk)


# ---------------------------------------------------------------------------
# HKDF-SHA256 (RFC 5869)
# ---------------------------------------------------------------------------


def hkdf_sha256(ikm: bytes, info: bytes, salt: bytes = b"", length: int = 32) -> bytes:
    prk = hmac.new(salt or b"\x00" * 32, ikm, hashlib.sha256).digest()
    out = b""
    t = b""
    counter = 1
    while len(out) < length:
        t = hmac.new(prk, t + info + bytes([counter]), hashlib.sha256).digest()
        out += t
        counter += 1
    return out[:length]


# ---------------------------------------------------------------------------
# ChaCha20 (RFC 8439)
# ---------------------------------------------------------------------------


def _rotl(x, n):
    return ((x << n) | (x >> (32 - n))) & 0xFFFFFFFF


def _quarter(s, a, b, c, d):
    s[a] = (s[a] + s[b]) & 0xFFFFFFFF
    s[d] = _rotl(s[d] ^ s[a], 16)
    s[c] = (s[c] + s[d]) & 0xFFFFFFFF
    s[b] = _rotl(s[b] ^ s[c], 12)
    s[a] = (s[a] + s[b]) & 0xFFFFFFFF
    s[d] = _rotl(s[d] ^ s[a], 8)
    s[c] = (s[c] + s[d]) & 0xFFFFFFFF
    s[b] = _rotl(s[b] ^ s[c], 7)


def _chacha20_block(key: bytes, counter: int, nonce: bytes) -> bytes:
    state = [
        0x61707865, 0x3320646E, 0x79622D32, 0x6B206574,
        *struct.unpack("<8I", key),
        counter,
        *struct.unpack("<3I", nonce),
    ]
    work = list(state)
    for _ in range(10):
        _quarter(work, 0, 4, 8, 12)
        _quarter(work, 1, 5, 9, 13)
        _quarter(work, 2, 6, 10, 14)
        _quarter(work, 3, 7, 11, 15)
        _quarter(work, 0, 5, 10, 15)
        _quarter(work, 1, 6, 11, 12)
        _quarter(work, 2, 7, 8, 13)
        _quarter(work, 3, 4, 9, 14)
    return struct.pack("<16I", *[(w + s) & 0xFFFFFFFF for w, s in zip(work, state)])


def chacha20_xor(key: bytes, nonce: bytes, data: bytes, counter: int = 1) -> bytes:
    out = bytearray()
    for i in range(0, len(data), 64):
        block = _chacha20_block(key, counter + i // 64, nonce)
        chunk = data[i : i + 64]
        out += bytes(a ^ b for a, b in zip(chunk, block))
    return bytes(out)


# ---------------------------------------------------------------------------
# Poly1305 (RFC 8439)
# ---------------------------------------------------------------------------


def poly1305_mac(key32: bytes, msg: bytes) -> bytes:
    r = int.from_bytes(key32[:16], "little") & 0x0FFFFFFC0FFFFFFC0FFFFFFC0FFFFFFF
    s = int.from_bytes(key32[16:32], "little")
    p = (1 << 130) - 5
    acc = 0
    for i in range(0, len(msg), 16):
        block = msg[i : i + 16]
        n = int.from_bytes(block + b"\x01", "little")
        acc = (acc + n) * r % p
    return ((acc + s) & ((1 << 128) - 1)).to_bytes(16, "little")


def _pad16(data: bytes) -> bytes:
    return b"\x00" * ((16 - len(data) % 16) % 16)


def chacha20poly1305_encrypt(key: bytes, nonce: bytes, plaintext: bytes,
                             aad: bytes = b"") -> bytes:
    otk = _chacha20_block(key, 0, nonce)[:32]
    ct = chacha20_xor(key, nonce, plaintext, counter=1)
    mac_data = (
        aad + _pad16(aad) + ct + _pad16(ct)
        + struct.pack("<QQ", len(aad), len(ct))
    )
    return ct + poly1305_mac(otk, mac_data)


def chacha20poly1305_decrypt(key: bytes, nonce: bytes, data: bytes,
                             aad: bytes = b"") -> bytes:
    if len(data) < 16:
        raise ValueError("ciphertext too short")
    ct, tag = data[:-16], data[-16:]
    otk = _chacha20_block(key, 0, nonce)[:32]
    mac_data = (
        aad + _pad16(aad) + ct + _pad16(ct)
        + struct.pack("<QQ", len(aad), len(ct))
    )
    if not hmac.compare_digest(poly1305_mac(otk, mac_data), tag):
        raise ValueError("authentication failed")
    return chacha20_xor(key, nonce, ct, counter=1)
