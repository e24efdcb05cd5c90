"""BN254 arithmetic in plain Python ints: the scalar field, Fq2, and affine
G1 / G2 points (None is the point at infinity).

The constants are the curve's published parameters (ark-bn254 0.5, EIP-196 /
EIP-197). The point formulas are the textbook affine chord-and-tangent ones;
they are slow and simple on purpose: the reference makes a handful of scalar
multiplications a proof.
"""

from __future__ import annotations

P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617

FR_TWO_ADICITY = 28
FR_TWO_ADIC_ROOT = pow(5, (R - 1) >> FR_TWO_ADICITY, R)

# b' = 3 / (9 + u), the twist's constant
B_G2 = (19485874751759354771024239261021720505790618469301721065564631296452457478373,
        266929791119991161246907387137283842545076965332900288569378510910307636690)
# #E'(Fq) / r
G2_COFACTOR = 21888242871839275222246405745257275088844257914179612981679871602714643921549


def inv(a: int, p: int = P) -> int:
    a %= p
    if a == 0:
        raise ZeroDivisionError("inverse of zero")
    return pow(a, p - 2, p)


def sqrt_fq(a: int):
    """A square root mod P (P = 3 mod 4), or None."""
    a %= P
    y = pow(a, (P + 1) // 4, P)
    return y if y * y % P == a else None


# ---------------------------------------------------------------- Fq2 ----

def f2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def f2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def f2_neg(a):
    return ((-a[0]) % P, (-a[1]) % P)


def f2_mul(a, b):
    """(a0 + a1 u)(b0 + b1 u) with u^2 = -1."""
    return ((a[0] * b[0] - a[1] * b[1]) % P, (a[0] * b[1] + a[1] * b[0]) % P)


def f2_scale(a, k: int):
    return (a[0] * k % P, a[1] * k % P)


def f2_inv(a):
    n = inv(a[0] * a[0] + a[1] * a[1])
    return (a[0] * n % P, (-a[1]) * n % P)


def f2_sqrt(a):
    """A square root in Fq2 by the complex method, or None."""
    a0, a1 = a[0] % P, a[1] % P
    if a0 == 0 and a1 == 0:
        return (0, 0)
    if a1 == 0:
        r = sqrt_fq(a0)
        return (r, 0) if r is not None else (0, sqrt_fq(-a0))
    alpha = sqrt_fq(a0 * a0 + a1 * a1)
    if alpha is None:
        return None
    half = inv(2)
    for delta in ((a0 + alpha) * half % P, (a0 - alpha) * half % P):
        x0 = sqrt_fq(delta)
        if x0:
            cand = (x0, a1 * inv(2 * x0) % P)
            if f2_mul(cand, cand) == (a0, a1):
                return cand
    return None


def f2_gt(a, b) -> bool:
    """arkworks' order on Fq2: c1 first, then c0."""
    return (a[1], a[0]) > (b[1], b[0])


# ------------------------------------------------------------- points ----

class _Curve:
    """Affine short Weierstrass arithmetic over a field given by its ops."""

    def __init__(self, add, sub, mul, scale, inv_, zero, b):
        self.fadd, self.fsub, self.fmul = add, sub, mul
        self.fscale, self.finv, self.zero, self.b = scale, inv_, zero, b

    def neg(self, pt):
        return None if pt is None else (pt[0], self.fsub(self.zero, pt[1]))

    def add(self, p1, p2):
        if p1 is None:
            return p2
        if p2 is None:
            return p1
        (x1, y1), (x2, y2) = p1, p2
        if x1 == x2:
            if self.fadd(y1, y2) == self.zero:
                return None
            m = self.fmul(self.fscale(self.fmul(x1, x1), 3),
                          self.finv(self.fscale(y1, 2)))
        else:
            m = self.fmul(self.fsub(y2, y1), self.finv(self.fsub(x2, x1)))
        x3 = self.fsub(self.fsub(self.fmul(m, m), x1), x2)
        return (x3, self.fsub(self.fmul(m, self.fsub(x1, x3)), y1))

    def mul(self, pt, k: int):
        """k * pt for an integer k >= 0 (not reduced: cofactors are larger
        than r)."""
        acc = None
        for bit in bin(k)[2:]:
            acc = self.add(acc, acc)
            if bit == "1":
                acc = self.add(acc, pt)
        return acc


G1 = _Curve(lambda a, b: (a + b) % P, lambda a, b: (a - b) % P,
            lambda a, b: a * b % P, lambda a, k: a * k % P, inv, 0, 3)
G2 = _Curve(f2_add, f2_sub, f2_mul, f2_scale, f2_inv, (0, 0), B_G2)
