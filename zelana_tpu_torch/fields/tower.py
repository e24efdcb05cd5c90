"""BN254 extension-field tower over plain tuples (golden / host-side layer).

Tower construction (identical to arkworks ark-bn254, so that G2/pairing values
and serialized bytes interoperate with the reference artifacts
prover/l2_vk.json, prover/l2_proof.json):

    Fq2  = Fq[u]  / (u^2 + 1)
    Fq6  = Fq2[v] / (v^3 - xi),  xi = 9 + u
    Fq12 = Fq6[w] / (w^2 - v)

Elements are nested tuples of ints:
    Fq2:  (c0, c1)
    Fq6:  (Fq2, Fq2, Fq2)
    Fq12: (Fq6, Fq6)

Functions are module-level and non-allocating beyond tuples; this is the
verification-side math (Groth16 verify, point decompression, subgroup checks).
The prover's hot loops use the batched limb kernels instead.
"""

from __future__ import annotations

from .bn254 import P
from .fp import inv_mod, sqrt_mod, legendre

# ---------------------------------------------------------------------------
# Fq2
# ---------------------------------------------------------------------------

XI = (9, 1)  # v^3 = xi = 9 + u

FQ2_ZERO = (0, 0)
FQ2_ONE = (1, 0)


def fq2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def fq2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def fq2_neg(a):
    return ((-a[0]) % P, (-a[1]) % P)


def fq2_mul(a, b):
    # (a0 + a1 u)(b0 + b1 u) with u^2 = -1
    t0 = a[0] * b[0] % P
    t1 = a[1] * b[1] % P
    t2 = (a[0] + a[1]) * (b[0] + b[1]) % P
    return ((t0 - t1) % P, (t2 - t0 - t1) % P)


def fq2_sqr(a):
    return fq2_mul(a, a)


def fq2_scale(a, k: int):
    return (a[0] * k % P, a[1] * k % P)


def fq2_conj(a):
    return (a[0], (-a[1]) % P)


def fq2_inv(a):
    # 1 / (a0 + a1 u) = conj(a) / (a0^2 + a1^2)
    norm = (a[0] * a[0] + a[1] * a[1]) % P
    ninv = inv_mod(norm, P)
    return (a[0] * ninv % P, (-a[1]) * ninv % P)


def fq2_pow(a, e: int):
    r = FQ2_ONE
    base = a
    while e > 0:
        if e & 1:
            r = fq2_mul(r, base)
        base = fq2_sqr(base)
        e >>= 1
    return r


def fq2_is_zero(a):
    return a[0] == 0 and a[1] == 0


def fq2_sqrt(a):
    """Square root in Fq2 (complex method, u^2 = -1). None if no root."""
    if fq2_is_zero(a):
        return FQ2_ZERO
    a0, a1 = a
    if a1 == 0:
        r = sqrt_mod(a0, P)
        if r is not None:
            return (r, 0)
        # sqrt(a0) = sqrt(-a0) * u  since u^2 = -1
        r = sqrt_mod((-a0) % P, P)
        assert r is not None
        return (0, r)
    norm = (a0 * a0 + a1 * a1) % P
    alpha = sqrt_mod(norm, P)
    if alpha is None:
        return None
    inv2 = inv_mod(2, P)
    delta = (a0 + alpha) * inv2 % P
    if legendre(delta, P) != 1:
        delta = (delta - alpha) % P
        if legendre(delta, P) != 1 and delta != 0:
            return None
    x0 = sqrt_mod(delta, P)
    if x0 is None:
        return None
    if x0 == 0:
        return None
    x1 = a1 * inv_mod(2 * x0 % P, P) % P
    cand = (x0, x1)
    if fq2_sqr(cand) != (a0 % P, a1 % P):
        return None
    return cand


def fq2_cmp_gt(a, b) -> bool:
    """arkworks QuadExtField ordering: compare c1 first, then c0."""
    if a[1] != b[1]:
        return a[1] > b[1]
    return a[0] > b[0]


# ---------------------------------------------------------------------------
# Fq6 = Fq2[v] / (v^3 - xi)
# ---------------------------------------------------------------------------

FQ6_ZERO = (FQ2_ZERO, FQ2_ZERO, FQ2_ZERO)
FQ6_ONE = (FQ2_ONE, FQ2_ZERO, FQ2_ZERO)


def _mul_by_xi(a):
    # (9 + u) * (a0 + a1 u) = (9 a0 - a1) + (9 a1 + a0) u
    return ((9 * a[0] - a[1]) % P, (9 * a[1] + a[0]) % P)


def fq6_add(a, b):
    return tuple(fq2_add(x, y) for x, y in zip(a, b))


def fq6_sub(a, b):
    return tuple(fq2_sub(x, y) for x, y in zip(a, b))


def fq6_neg(a):
    return tuple(fq2_neg(x) for x in a)


def fq6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = fq2_mul(a0, b0)
    t1 = fq2_mul(a1, b1)
    t2 = fq2_mul(a2, b2)
    c0 = fq2_add(t0, _mul_by_xi(fq2_sub(fq2_mul(fq2_add(a1, a2), fq2_add(b1, b2)), fq2_add(t1, t2))))
    c1 = fq2_add(fq2_sub(fq2_mul(fq2_add(a0, a1), fq2_add(b0, b1)), fq2_add(t0, t1)), _mul_by_xi(t2))
    c2 = fq2_add(fq2_sub(fq2_mul(fq2_add(a0, a2), fq2_add(b0, b2)), fq2_add(t0, t2)), t1)
    return (c0, c1, c2)


def fq6_sqr(a):
    return fq6_mul(a, a)


def fq6_inv(a):
    a0, a1, a2 = a
    c0 = fq2_sub(fq2_sqr(a0), _mul_by_xi(fq2_mul(a1, a2)))
    c1 = fq2_sub(_mul_by_xi(fq2_sqr(a2)), fq2_mul(a0, a1))
    c2 = fq2_sub(fq2_sqr(a1), fq2_mul(a0, a2))
    t = fq2_add(fq2_mul(a2, _mul_by_xi_arg(c1)), fq2_mul(a1, _mul_by_xi_arg(c2)))
    t = fq2_add(t, fq2_mul(a0, c0))
    tinv = fq2_inv(t)
    return (fq2_mul(c0, tinv), fq2_mul(c1, tinv), fq2_mul(c2, tinv))


def _mul_by_xi_arg(a):
    return _mul_by_xi(a)


def fq6_is_zero(a):
    return all(fq2_is_zero(x) for x in a)


# ---------------------------------------------------------------------------
# Fq12 = Fq6[w] / (w^2 - v)
# ---------------------------------------------------------------------------

FQ12_ZERO = (FQ6_ZERO, FQ6_ZERO)
FQ12_ONE = (FQ6_ONE, FQ6_ZERO)


def _mul_by_v(a):
    # v * (a0 + a1 v + a2 v^2) = xi*a2 + a0 v + a1 v^2
    return (_mul_by_xi(a[2]), a[0], a[1])


def fq12_add(a, b):
    return (fq6_add(a[0], b[0]), fq6_add(a[1], b[1]))


def fq12_sub(a, b):
    return (fq6_sub(a[0], b[0]), fq6_sub(a[1], b[1]))


def fq12_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = fq6_mul(a0, b0)
    t1 = fq6_mul(a1, b1)
    c0 = fq6_add(t0, _mul_by_v(t1))
    c1 = fq6_sub(fq6_sub(fq6_mul(fq6_add(a0, a1), fq6_add(b0, b1)), t0), t1)
    return (c0, c1)


def fq12_sqr(a):
    return fq12_mul(a, a)


def fq12_conj(a):
    return (a[0], fq6_neg(a[1]))


def fq12_inv(a):
    a0, a1 = a
    t = fq6_sub(fq6_sqr(a0), _mul_by_v(fq6_sqr(a1)))
    tinv = fq6_inv(t)
    return (fq6_mul(a0, tinv), fq6_neg(fq6_mul(a1, tinv)))


def fq12_pow(a, e: int):
    r = FQ12_ONE
    base = a
    while e > 0:
        if e & 1:
            r = fq12_mul(r, base)
        base = fq12_sqr(base)
        e >>= 1
    return r


def fq12_is_one(a):
    return a == FQ12_ONE
