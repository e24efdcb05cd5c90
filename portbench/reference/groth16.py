"""The Groth16 proof a prover must return, worked out from the keygen's
secrets instead of from the proving key's points.

The key of a circuit is made from StdRng(seed) (stdrng.toxic_waste): with
alpha, beta, gamma, delta, t and the generators g1, g2 known, every query
point is a known multiple of g1 or g2, and so is every proof:

  A = (alpha + a(t) + r delta) g1          a(t) = sum_j (A z)_j L_j(t)
  B = (beta + b(t) + s delta) g2                 + sum_{i<ni} z_i L_{nc+i}(t)
  C = ((beta a_w(t) + alpha b_w(t) + c_w(t)) + (a(t) b(t) - c(t))) / delta
      + s A + r B - r s delta

with L_j the Lagrange basis of the domain of m = 2^k >= nc + ni points,
the ni input-consistency rows appended to A, and _w the witness columns'
part (the whole minus the instance columns' part). (a b - c)(t) = h(t) Z(t)
holds exactly when the assignment satisfies every constraint, which the
ConstraintSystem checks as it goes. r and s come from StdRng(batch_id).

So a proof costs one pass over the constraints and three scalar
multiplications, and no multi-scalar multiplication at all.
"""

from __future__ import annotations

from .bn254 import G1, G2, R as FR, FR_TWO_ADIC_ROOT, FR_TWO_ADICITY, inv
from .cs import ConstraintSystem
from .stdrng import prove_randomness, toxic_waste


def domain_size(num_rows: int) -> int:
    return 1 << max(1, (num_rows - 1).bit_length())


class Lagrange:
    """w_j = omega^j / (t - omega^j) for j < n (L_j(t) = w_j Z(t) / m), by
    one batch inversion."""

    def __init__(self, t: int, m: int, n: int):
        log_m = (m - 1).bit_length()
        omega = pow(FR_TWO_ADIC_ROOT, 1 << (FR_TWO_ADICITY - log_m), FR)
        powers = [1] * n
        for j in range(1, n):
            powers[j] = powers[j - 1] * omega % FR
        prefix = [0] * n
        acc = 1
        for j in range(n):
            acc = acc * (t - powers[j]) % FR
            prefix[j] = acc
        acc = inv(acc, FR)
        w = [0] * n
        for j in range(n - 1, -1, -1):
            before = prefix[j - 1] if j else 1
            w[j] = acc * before % FR * powers[j] % FR
            acc = acc * (t - powers[j]) % FR
        self.t, self.m, self.w = t, m, w
        self.scale = (pow(t, m, FR) - 1) * inv(m, FR) % FR

    def dot(self, values, offset: int = 0) -> int:
        """sum_j values[j] L_{offset + j}(t)."""
        w = self.w
        acc = 0
        for j, v in enumerate(values, offset):
            if v:
                acc += v * w[j]
        return acc % FR * self.scale % FR


class Key:
    """A circuit's keygen secrets and its Lagrange weights at t."""

    def __init__(self, seed: int, num_rows: int):
        self.m = domain_size(num_rows)
        self.secret = toxic_waste(seed, self.m)
        self.lagrange = Lagrange(self.secret["t"], self.m, num_rows)


def proof_scalars(key: Key, cs: ConstraintSystem, batch_id: int) -> tuple:
    """(A, B, C) as multiples of g1, g2, g1."""
    if cs.first_bad is not None:
        raise ValueError(f"constraint {cs.first_bad} unsatisfied")
    sec, lag = key.secret, key.lagrange
    nc, ni = cs.num_constraints, len(cs.inputs)
    if domain_size(nc + ni) != key.m:
        raise ValueError("the circuit does not fit the key's domain")
    inputs_part = lag.dot(cs.inputs, nc)
    a, b, c = (lag.dot(rows) for rows in cs.rows)
    a = (a + inputs_part) % FR
    ai, bi, ci = (lag.dot(rows) for rows in cs.inst)
    ai = (ai + inputs_part) % FR
    alpha, beta, delta = sec["alpha"], sec["beta"], sec["delta"]
    r, s = prove_randomness(batch_id)
    sa = (alpha + a + r * delta) % FR
    sb = (beta + b + s * delta) % FR
    witness = (beta * (a - ai) + alpha * (b - bi) + (c - ci)) % FR
    sc = ((witness + a * b - c) * inv(delta, FR) + s * sa + r * sb
          - r * s % FR * delta) % FR
    return sa, sb, sc


def proof_points(key: Key, cs: ConstraintSystem, batch_id: int) -> tuple:
    sa, sb, sc = proof_scalars(key, cs, batch_id)
    g1, g2 = key.secret["g1"], key.secret["g2"]
    return G1.mul(g1, sa), G2.mul(g2, sb), G1.mul(g1, sc)


def solana_bytes(points) -> bytes:
    """The deployed verifier's 256 bytes: -A, B, C, big-endian, G2 with the
    imaginary part first (EIP-197)."""
    a, b, c = points
    a = G1.neg(a)
    (x0, x1), (y0, y1) = b
    return b"".join(int(v).to_bytes(32, "big") for v in (
        a[0], a[1], x1, x0, y1, y0, c[0], c[1]))
