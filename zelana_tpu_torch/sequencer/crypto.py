"""Host-side signature crypto: Ed25519 (RFC 8032) sign/verify.

The reference verifies transfer signatures with ed25519-dalek
(core/src/sequencer/execution/tx_router.rs; sdk/keypair). This is a compact
pure-Python implementation of the same scheme -- sufficient for sequencer
verification parity; a native batch verifier is a later optimization.
"""

from __future__ import annotations

import hashlib

P = 2**255 - 19
L_ORDER = 2**252 + 27742317777372353535851937790883648493
D = (-121665 * pow(121666, P - 2, P)) % P
BASE_Y = 4 * pow(5, P - 2, P) % P


def _recover_x(y: int, sign: int):
    x2 = (y * y - 1) * pow(D * y * y + 1, P - 2, P) % P
    if x2 == 0:
        return 0 if sign == 0 else None
    x = pow(x2, (P + 3) // 8, P)
    if (x * x - x2) % P != 0:
        x = x * pow(2, (P - 1) // 4, P) % P
    if (x * x - x2) % P != 0:
        return None
    if x & 1 != sign:
        x = P - x
    return x


BASE = (_recover_x(BASE_Y, 0), BASE_Y, 1, _recover_x(BASE_Y, 0) * BASE_Y % P)
IDENT = (0, 1, 1, 0)


def _add(q, r):
    x1, y1, z1, t1 = q
    x2, y2, z2, t2 = r
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = 2 * t1 * t2 * D % P
    dd = 2 * z1 * z2 % P
    e, f, g, h = b - a, dd - c, dd + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def _mul(pt, s):
    r = IDENT
    while s > 0:
        if s & 1:
            r = _add(r, pt)
        pt = _add(pt, pt)
        s >>= 1
    return r


def _compress(pt) -> bytes:
    x, y, z, _ = pt
    zinv = pow(z, P - 2, P)
    x, y = x * zinv % P, y * zinv % P
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def _decompress(data: bytes):
    v = int.from_bytes(data, "little")
    sign = v >> 255
    y = v & ((1 << 255) - 1)
    if y >= P:
        return None
    x = _recover_x(y, sign)
    if x is None:
        return None
    return (x, y, 1, x * y % P)


def _sha512(*parts: bytes) -> int:
    h = hashlib.sha512()
    for p in parts:
        h.update(p)
    return int.from_bytes(h.digest(), "little")


def secret_to_keypair(seed: bytes):
    """32-byte seed -> (scalar, prefix, public_key_bytes)."""
    h = hashlib.sha512(seed).digest()
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    prefix = h[32:]
    pub = _compress(_mul(BASE, a))
    return a, prefix, pub


def sign(seed: bytes, message: bytes) -> bytes:
    a, prefix, pub = secret_to_keypair(seed)
    r = _sha512(prefix, message) % L_ORDER
    r_pt = _compress(_mul(BASE, r))
    k = _sha512(r_pt, pub, message) % L_ORDER
    s = (r + k * a) % L_ORDER
    return r_pt + s.to_bytes(32, "little")


def verify(public_key: bytes, message: bytes, signature: bytes) -> bool:
    if len(signature) != 64 or len(public_key) != 32:
        return False
    a_pt = _decompress(public_key)
    r_pt = _decompress(signature[:32])
    if a_pt is None or r_pt is None:
        return False
    s = int.from_bytes(signature[32:], "little")
    if s >= L_ORDER:
        return False
    k = _sha512(signature[:32], public_key, message) % L_ORDER
    lhs = _mul(BASE, s)
    rhs = _add(r_pt, _mul(a_pt, k))
    return _compress(lhs) == _compress(rhs)
