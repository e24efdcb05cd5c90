"""BN254 optimal ate pairing (golden, host-side).

Used for Groth16 verification against the reference's on-chain pairing check
(onchain_verifier/src/lib.rs:497-545: product of four pairings == 1) and for
validating device-generated proofs in tests without any external library.

Strategy: embed G2 into E(Fq12) through the twist map psi(x, y) = (x*w^2,
y*w^3) (w^6 = xi), run a textbook Miller loop in affine coordinates over
Fq12, and finish with a plain final exponentiation by (p^12 - 1) / r.
Simplicity over speed: this code verifies proofs; it never sits on the
proving hot path.
"""

from __future__ import annotations

from ..fields.bn254 import P, R, BN_X
from ..fields import tower as tw

# ate loop count = 6x + 2
ATE_LOOP_COUNT = 6 * BN_X + 2

FINAL_EXP = (P**12 - 1) // R


# ---------------------------------------------------------------------------
# Fq12 element helpers for embedded points
# ---------------------------------------------------------------------------


def _fq12(c0=tw.FQ6_ZERO, c1=tw.FQ6_ZERO):
    return (c0, c1)


def embed_fq(x: int):
    """Fq -> Fq12."""
    return (((x % P, 0), tw.FQ2_ZERO, tw.FQ2_ZERO), tw.FQ6_ZERO)


def twist(pt):
    """G2 (affine over Fq2) -> E(Fq12): (x*w^2, y*w^3) with w^2 = v."""
    if pt is None:
        return None
    (x, y) = pt
    X = ((tw.FQ2_ZERO, x, tw.FQ2_ZERO), tw.FQ6_ZERO)  # x * v
    Y = (tw.FQ6_ZERO, (tw.FQ2_ZERO, y, tw.FQ2_ZERO))  # y * v * w
    return (X, Y)


def embed_g1(pt):
    if pt is None:
        return None
    return (embed_fq(pt[0]), embed_fq(pt[1]))


# generic curve ops over Fq12 (curve y^2 = x^3 + 3)


def _add12(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if tw.fq12_add(y1, y2) == tw.FQ12_ZERO:
            return None
        num = tw.fq12_mul(embed_fq(3), tw.fq12_mul(x1, x1))
        den = tw.fq12_mul(embed_fq(2), y1)
        m = tw.fq12_mul(num, tw.fq12_inv(den))
    else:
        m = tw.fq12_mul(tw.fq12_sub(y2, y1), tw.fq12_inv(tw.fq12_sub(x2, x1)))
    x3 = tw.fq12_sub(tw.fq12_sub(tw.fq12_mul(m, m), x1), x2)
    y3 = tw.fq12_sub(tw.fq12_mul(m, tw.fq12_sub(x1, x3)), y1)
    return (x3, y3)


def _linefunc(p1, p2, t):
    """Evaluate the line through p1, p2 at point t (all in E(Fq12))."""
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if x1 != x2:
        m = tw.fq12_mul(tw.fq12_sub(y2, y1), tw.fq12_inv(tw.fq12_sub(x2, x1)))
        return tw.fq12_sub(tw.fq12_mul(m, tw.fq12_sub(xt, x1)), tw.fq12_sub(yt, y1))
    elif y1 == y2:
        m = tw.fq12_mul(
            tw.fq12_mul(embed_fq(3), tw.fq12_mul(x1, x1)),
            tw.fq12_inv(tw.fq12_mul(embed_fq(2), y1)),
        )
        return tw.fq12_sub(tw.fq12_mul(m, tw.fq12_sub(xt, x1)), tw.fq12_sub(yt, y1))
    else:
        return tw.fq12_sub(xt, x1)


def _frob12(a):
    """Fq12 Frobenius x -> x^p (generic; used on point coordinates only)."""
    return tw.fq12_pow(a, P)


def miller_loop(q_emb, p_emb):
    """Miller loop for optimal ate pairing; returns f before final exp."""
    if q_emb is None or p_emb is None:
        return tw.FQ12_ONE
    t = q_emb
    f = tw.FQ12_ONE
    bits = bin(ATE_LOOP_COUNT)[2:]
    for bit in bits[1:]:
        f = tw.fq12_mul(tw.fq12_mul(f, f), _linefunc(t, t, p_emb))
        t = _add12(t, t)
        if bit == "1":
            f = tw.fq12_mul(f, _linefunc(t, q_emb, p_emb))
            t = _add12(t, q_emb)
    # Frobenius endomorphism steps
    q1 = (_frob12(q_emb[0]), _frob12(q_emb[1]))
    nq2 = (_frob12(q1[0]), tw.fq12_sub(tw.FQ12_ZERO, _frob12(q1[1])))
    f = tw.fq12_mul(f, _linefunc(t, q1, p_emb))
    t = _add12(t, q1)
    f = tw.fq12_mul(f, _linefunc(t, nq2, p_emb))
    return f


def final_exponentiation(f):
    return tw.fq12_pow(f, FINAL_EXP)


def pairing(p_g1, q_g2):
    """e(P, Q) for P in G1 (affine ints), Q in G2 (affine Fq2)."""
    if p_g1 is None or q_g2 is None:
        return tw.FQ12_ONE
    f = miller_loop(twist(q_g2), embed_g1(p_g1))
    return final_exponentiation(f)


def multi_pairing(pairs):
    """prod e(P_i, Q_i), sharing one final exponentiation."""
    f = tw.FQ12_ONE
    for p_g1, q_g2 in pairs:
        if p_g1 is None or q_g2 is None:
            continue
        f = tw.fq12_mul(f, miller_loop(twist(q_g2), embed_g1(p_g1)))
    return final_exponentiation(f)


def pairing_product_is_one(pairs) -> bool:
    return multi_pairing(pairs) == tw.FQ12_ONE
