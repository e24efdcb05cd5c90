"""Model of Solana's alt_bn128 syscalls (EVM-convention big-endian).

The deployed verifier program (onchain-programs/verifier lib.rs:497-545)
feeds raw instruction bytes into `alt_bn128_multiplication`,
`alt_bn128_addition` and `alt_bn128_pairing`. Those syscalls implement the
Ethereum precompiles (EIP-196/197) byte-for-byte:

- G1 point: 64 bytes, x || y, 32-byte BIG-ENDIAN field elements;
  the all-zero encoding is the point at infinity.
- Scalar: 32 bytes big-endian (multiplication does NOT range-check the
  scalar; it reduces mod r).
- G2 point (pairing input): 128 bytes, x_c1 || x_c0 || y_c1 || y_c0 --
  the "imaginary" coefficient FIRST (EIP-197 ordering).
- addition input: 128 bytes (two G1); multiplication: 96 bytes (G1 ||
  scalar); pairing: k * 192 bytes (G1 || G2 pairs), output 32 bytes,
  big-endian 1 if the product of pairings equals one.
- Invalid encodings (coordinate >= q, point not on curve, G2 not in the
  r-torsion subgroup) make the syscall return an error -> SyscallError.

This module is the acceptance gate's ground truth: a proof our settler
submits must verify through these exact byte semantics, the way the
reference tests use litesvm to host the real program.
"""

from __future__ import annotations

from ..curves import g1 as G1
from ..curves import g2 as G2
from ..curves.pairing import pairing_product_is_one
from ..fields.bn254 import P as Q_MOD, R as R_MOD


class SyscallError(Exception):
    pass


def _fq_be(data: bytes) -> int:
    v = int.from_bytes(data, "big")
    if v >= Q_MOD:
        raise SyscallError("coordinate >= base field modulus")
    return v


def decode_g1(data: bytes):
    """64 BE bytes -> affine point or None (infinity). Validates curve."""
    if len(data) != 64:
        raise SyscallError("bad G1 length")
    x = _fq_be(data[:32])
    y = _fq_be(data[32:])
    if x == 0 and y == 0:
        return None
    pt = (x, y)
    if not G1.is_on_curve(pt):
        raise SyscallError("G1 point not on curve")
    return pt


def encode_g1(pt) -> bytes:
    if pt is None:
        return b"\x00" * 64
    return int(pt[0]).to_bytes(32, "big") + int(pt[1]).to_bytes(32, "big")


def decode_g2(data: bytes):
    """128 BE bytes, EIP-197 order (x_c1 || x_c0 || y_c1 || y_c0)."""
    if len(data) != 128:
        raise SyscallError("bad G2 length")
    x1 = _fq_be(data[0:32])
    x0 = _fq_be(data[32:64])
    y1 = _fq_be(data[64:96])
    y0 = _fq_be(data[96:128])
    if x0 == 0 and x1 == 0 and y0 == 0 and y1 == 0:
        return None
    pt = ((x0, x1), (y0, y1))
    if not G2.is_on_curve(pt):
        raise SyscallError("G2 point not on curve")
    if not G2.in_subgroup(pt):
        raise SyscallError("G2 point not in r-torsion subgroup")
    return pt


def encode_g2(pt) -> bytes:
    if pt is None:
        return b"\x00" * 128
    (x0, x1), (y0, y1) = pt
    return (
        int(x1).to_bytes(32, "big")
        + int(x0).to_bytes(32, "big")
        + int(y1).to_bytes(32, "big")
        + int(y0).to_bytes(32, "big")
    )


def alt_bn128_addition(data: bytes) -> bytes:
    if len(data) != 128:
        raise SyscallError("addition input must be 128 bytes")
    a = decode_g1(data[:64])
    b = decode_g1(data[64:])
    return encode_g1(G1.add(a, b))


def alt_bn128_multiplication(data: bytes) -> bytes:
    if len(data) != 96:
        raise SyscallError("multiplication input must be 96 bytes")
    pt = decode_g1(data[:64])
    k = int.from_bytes(data[64:96], "big") % R_MOD
    if pt is None or k == 0:
        return encode_g1(None)
    return encode_g1(G1.mul(pt, k))


def alt_bn128_pairing(data: bytes) -> bytes:
    if len(data) % 192 != 0:
        raise SyscallError("pairing input must be a multiple of 192 bytes")
    pairs = []
    for off in range(0, len(data), 192):
        p = decode_g1(data[off:off + 64])
        q = decode_g2(data[off + 64:off + 192])
        if p is None or q is None:
            continue  # e(O, Q) = e(P, O) = 1
        pairs.append((p, q))
    ok = pairing_product_is_one(pairs) if pairs else True
    out = bytearray(32)
    out[31] = 1 if ok else 0
    return bytes(out)
