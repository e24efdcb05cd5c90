"""BN254 G1 golden implementation (affine, Python ints).

Point representation: tuple ``(x, y)`` of Fq ints, or ``None`` for the point
at infinity. This is the host/verification-side path; batched device point
kernels live in :mod:`zelana_tpu_torch.ops.curve_kernels`.

Serialization matches arkworks ark-serialize =0.5.0 compressed short
Weierstrass encoding (32 bytes LE x-coordinate, flag bits in the two MSBs of
the final byte: bit7 = "y is negative (larger)", bit6 = infinity), which is
the on-disk format of the reference's proving/verifying keys and
prover/l2_proof.json.
"""

from __future__ import annotations

from ..fields.bn254 import P, R, B_G1, G1_GEN
from ..fields.fp import inv_mod, sqrt_mod

INF = None


def is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - (x * x * x + B_G1)) % P == 0


def neg(pt):
    if pt is None:
        return None
    return (pt[0], (-pt[1]) % P)


def add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        # doubling
        m = 3 * x1 * x1 % P * inv_mod(2 * y1, P) % P
    else:
        m = (y2 - y1) * inv_mod(x2 - x1, P) % P
    x3 = (m * m - x1 - x2) % P
    y3 = (m * (x1 - x3) - y1) % P
    return (x3, y3)


def double(pt):
    return add(pt, pt)


def _jac_double(X, Y, Z):
    if Z == 0 or Y == 0:
        return (0, 1, 0)
    A = X * X % P
    B = Y * Y % P
    C = B * B % P
    D = 2 * ((X + B) * (X + B) - A - C) % P
    E = 3 * A % P
    X3 = (E * E - 2 * D) % P
    return (X3, (E * (D - X3) - 8 * C) % P, 2 * Y * Z % P)


def _jac_add_affine(X, Y, Z, x2, y2):
    """Mixed Jacobian + affine addition."""
    if Z == 0:
        return (x2, y2, 1)
    Z2 = Z * Z % P
    U2 = x2 * Z2 % P
    S2 = y2 * Z * Z2 % P
    if U2 == X:
        if S2 == Y:
            return _jac_double(X, Y, Z)
        return (0, 1, 0)
    H = (U2 - X) % P
    HH = H * H % P
    I = 4 * HH % P
    J = H * I % P
    r2 = 2 * (S2 - Y) % P
    V = X * I % P
    X3 = (r2 * r2 - J - 2 * V) % P
    Y3 = (r2 * (V - X3) - 2 * Y * J) % P
    Z3 = ((Z + H) * (Z + H) - Z2 - HH) % P
    return (X3, Y3, Z3)


def mul(pt, k: int):
    """Scalar multiplication by the INTEGER k (negative k negates the
    point). Not reduced mod r: subgroup checks multiply by candidate
    orders, and G1 being prime-order makes the reduction redundant for
    legitimate scalars anyway.

    Jacobian MSB-first ladder with mixed adds and ONE final inversion:
    the previous affine ladder paid an inv_mod per point operation
    (~380 per scalar) and dominated host-side proof assembly."""
    if pt is None or k == 0:
        return None
    if k < 0:
        pt = neg(pt)
        k = -k
    x0, y0 = pt
    X, Y, Z = 0, 1, 0
    for bit in bin(k)[2:]:
        X, Y, Z = _jac_double(X, Y, Z)
        if bit == "1":
            X, Y, Z = _jac_add_affine(X, Y, Z, x0, y0)
    if Z == 0:
        return None
    zi = inv_mod(Z, P)
    zi2 = zi * zi % P
    return (X * zi2 % P, Y * zi2 * zi % P)


def msm(points, scalars):
    """Reference multi-scalar multiplication (slow; for golden tests only)."""
    acc = None
    for pt, s in zip(points, scalars):
        acc = add(acc, mul(pt, s))
    return acc


def generator():
    return G1_GEN


def in_subgroup(pt) -> bool:
    # G1 is prime order on BN254 (cofactor 1)
    return is_on_curve(pt)


# ---------------------------------------------------------------------------
# arkworks-compatible serialization
# ---------------------------------------------------------------------------

_FLAG_NEG = 1 << 7
_FLAG_INF = 1 << 6


def _y_is_negative(y: int) -> bool:
    """arkworks convention: y is 'negative' when y > -y as canonical ints."""
    return y > (P - y) % P


def serialize_compressed(pt) -> bytes:
    if pt is None:
        out = bytearray(32)
        out[-1] |= _FLAG_INF
        return bytes(out)
    x, y = pt
    out = bytearray(int(x).to_bytes(32, "little"))
    if _y_is_negative(y):
        out[-1] |= _FLAG_NEG
    return bytes(out)


def deserialize_compressed(data: bytes):
    assert len(data) == 32
    raw = bytearray(data)
    flags = raw[-1] & 0xC0
    raw[-1] &= 0x3F
    if flags & _FLAG_INF:
        return None
    x = int.from_bytes(bytes(raw), "little")
    assert x < P, "x out of field"
    y2 = (x * x * x + B_G1) % P
    y = sqrt_mod(y2, P)
    if y is None:
        raise ValueError("x not on curve")
    if _y_is_negative(y) != bool(flags & _FLAG_NEG):
        y = (P - y) % P
    pt = (x, y)
    assert is_on_curve(pt)
    return pt


def serialize_uncompressed(pt) -> bytes:
    """arkworks uncompressed: x LE || y LE, flags on last byte of y."""
    if pt is None:
        out = bytearray(64)
        out[-1] |= _FLAG_INF
        return bytes(out)
    x, y = pt
    return int(x).to_bytes(32, "little") + int(y).to_bytes(32, "little")


def deserialize_uncompressed(data: bytes):
    assert len(data) == 64
    raw = bytearray(data)
    flags = raw[-1] & 0xC0
    raw[-1] &= 0x3F
    if flags & _FLAG_INF:
        return None
    x = int.from_bytes(bytes(raw[:32]), "little")
    y = int.from_bytes(bytes(raw[32:]), "little")
    pt = (x, y)
    assert is_on_curve(pt)
    return pt
