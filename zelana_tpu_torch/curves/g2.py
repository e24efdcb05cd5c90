"""BN254 G2 golden implementation (affine over Fq2, Python ints).

Point representation: ``((x0, x1), (y0, y1))`` or ``None`` for infinity.

Serialization matches arkworks compressed G2: 64 bytes = x.c0 LE || x.c1 LE
with flag bits in the MSBs of the last byte; sign convention compares
(c1, c0) lexicographically (arkworks QuadExtField Ord).
"""

from __future__ import annotations

from ..fields.bn254 import P, R, B_G2_C0, B_G2_C1, G2_GEN_X, G2_GEN_Y
from ..fields.tower import (
    FQ2_ZERO,
    fq2_add,
    fq2_sub,
    fq2_neg,
    fq2_mul,
    fq2_sqr,
    fq2_inv,
    fq2_is_zero,
    fq2_sqrt,
    fq2_cmp_gt,
    fq2_scale,
)

B2 = (B_G2_C0, B_G2_C1)

INF = None


def is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    lhs = fq2_sqr(y)
    rhs = fq2_add(fq2_mul(fq2_sqr(x), x), B2)
    return lhs == rhs


def neg(pt):
    if pt is None:
        return None
    return (pt[0], fq2_neg(pt[1]))


def add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if fq2_is_zero(fq2_add(y1, y2)):
            return None
        m = fq2_mul(fq2_scale(fq2_sqr(x1), 3), fq2_inv(fq2_scale(y1, 2)))
    else:
        m = fq2_mul(fq2_sub(y2, y1), fq2_inv(fq2_sub(x2, x1)))
    x3 = fq2_sub(fq2_sub(fq2_sqr(m), x1), x2)
    y3 = fq2_sub(fq2_mul(m, fq2_sub(x1, x3)), y1)
    return (x3, y3)


def _jac_double(X, Y, Z):
    if fq2_is_zero(Z) or fq2_is_zero(Y):
        return (FQ2_ZERO, (1, 0), FQ2_ZERO)
    A = fq2_sqr(X)
    B = fq2_sqr(Y)
    C = fq2_sqr(B)
    D = fq2_scale(fq2_sub(fq2_sub(fq2_sqr(fq2_add(X, B)), A), C), 2)
    E = fq2_scale(A, 3)
    X3 = fq2_sub(fq2_sqr(E), fq2_scale(D, 2))
    Y3 = fq2_sub(fq2_mul(E, fq2_sub(D, X3)), fq2_scale(C, 8))
    Z3 = fq2_scale(fq2_mul(Y, Z), 2)
    return (X3, Y3, Z3)


def _jac_add_affine(X, Y, Z, x2, y2):
    """Mixed Jacobian + affine addition over Fq2."""
    if fq2_is_zero(Z):
        return (x2, y2, (1, 0))
    Z2 = fq2_sqr(Z)
    U2 = fq2_mul(x2, Z2)
    S2 = fq2_mul(fq2_mul(y2, Z), Z2)
    if U2 == X:
        if S2 == Y:
            return _jac_double(X, Y, Z)
        return (FQ2_ZERO, (1, 0), FQ2_ZERO)
    H = fq2_sub(U2, X)
    HH = fq2_sqr(H)
    I = fq2_scale(HH, 4)
    J = fq2_mul(H, I)
    r2 = fq2_scale(fq2_sub(S2, Y), 2)
    V = fq2_mul(X, I)
    X3 = fq2_sub(fq2_sub(fq2_sqr(r2), J), fq2_scale(V, 2))
    Y3 = fq2_sub(fq2_mul(r2, fq2_sub(V, X3)), fq2_scale(fq2_mul(Y, J), 2))
    Z3 = fq2_sub(fq2_sub(fq2_sqr(fq2_add(Z, H)), Z2), HH)
    return (X3, Y3, Z3)


def mul(pt, k: int):
    """Scalar multiplication by the INTEGER k -- deliberately not reduced
    mod r: G2 has a large cofactor, so callers multiply by values (the
    cofactor, candidate orders) that are only meaningful unreduced.
    Reducing here silently made `in_subgroup` a tautology (r * pt -> 0 * pt)
    and broke cofactor clearing.

    Jacobian MSB-first ladder with mixed adds and ONE final Fq2
    inversion (the affine ladder paid an fq2_inv per point operation)."""
    if pt is None or k == 0:
        return None
    if k < 0:
        pt = neg(pt)
        k = -k
    x0, y0 = pt
    X, Y, Z = FQ2_ZERO, (1, 0), FQ2_ZERO
    for bit in bin(k)[2:]:
        X, Y, Z = _jac_double(X, Y, Z)
        if bit == "1":
            X, Y, Z = _jac_add_affine(X, Y, Z, x0, y0)
    if fq2_is_zero(Z):
        return None
    zi = fq2_inv(Z)
    zi2 = fq2_sqr(zi)
    return (fq2_mul(X, zi2), fq2_mul(fq2_mul(Y, zi2), zi))


def msm(points, scalars):
    acc = None
    for pt, s in zip(points, scalars):
        acc = add(acc, mul(pt, s))
    return acc


def generator():
    return (G2_GEN_X, G2_GEN_Y)


def in_subgroup(pt) -> bool:
    """Membership in the order-r subgroup (G2 has a large cofactor)."""
    if pt is None:
        return True
    return is_on_curve(pt) and mul(pt, R) is None


# ---------------------------------------------------------------------------
# arkworks-compatible serialization
# ---------------------------------------------------------------------------

_FLAG_NEG = 1 << 7
_FLAG_INF = 1 << 6


def _y_is_negative(y) -> bool:
    return fq2_cmp_gt(y, fq2_neg(y))


def serialize_compressed(pt) -> bytes:
    if pt is None:
        out = bytearray(64)
        out[-1] |= _FLAG_INF
        return bytes(out)
    x, y = pt
    out = bytearray(int(x[0]).to_bytes(32, "little") + int(x[1]).to_bytes(32, "little"))
    if _y_is_negative(y):
        out[-1] |= _FLAG_NEG
    return bytes(out)


def deserialize_compressed(data: bytes):
    assert len(data) == 64
    raw = bytearray(data)
    flags = raw[-1] & 0xC0
    raw[-1] &= 0x3F
    if flags & _FLAG_INF:
        return None
    x0 = int.from_bytes(bytes(raw[:32]), "little")
    x1 = int.from_bytes(bytes(raw[32:]), "little")
    assert x0 < P and x1 < P
    x = (x0, x1)
    y2 = fq2_add(fq2_mul(fq2_sqr(x), x), B2)
    y = fq2_sqrt(y2)
    if y is None:
        raise ValueError("x not on curve")
    if _y_is_negative(y) != bool(flags & _FLAG_NEG):
        y = fq2_neg(y)
    pt = (x, y)
    assert is_on_curve(pt)
    return pt


def serialize_uncompressed(pt) -> bytes:
    if pt is None:
        out = bytearray(128)
        out[-1] |= _FLAG_INF
        return bytes(out)
    x, y = pt
    return (
        int(x[0]).to_bytes(32, "little")
        + int(x[1]).to_bytes(32, "little")
        + int(y[0]).to_bytes(32, "little")
        + int(y[1]).to_bytes(32, "little")
    )


def deserialize_uncompressed(data: bytes):
    assert len(data) == 128
    raw = bytearray(data)
    flags = raw[-1] & 0xC0
    raw[-1] &= 0x3F
    if flags & _FLAG_INF:
        return None
    vals = [int.from_bytes(bytes(raw[i : i + 32]), "little") for i in range(0, 128, 32)]
    pt = ((vals[0], vals[1]), (vals[2], vals[3]))
    assert is_on_curve(pt)
    return pt
