"""rand 0.8's StdRng (ChaCha12 seeded by rand_core's PCG32 seed_from_u64)
and arkworks' UniformRand sampling of Fr, Fq, G1 and G2.

Frozen from zelana_tpu_torch/groth16/stdrng.py, whose stream is held to
rand_chacha's and arkworks' by the repository's tests. The Groth16 keygen
draws alpha, beta, gamma, delta, the G1 and G2 generators and t from
StdRng(seed) in ark-groth16's order; a prove draws r then s from
StdRng(batch_id).
"""

from __future__ import annotations

from .bn254 import G2, G2_COFACTOR, P, R, f2_add, f2_gt, f2_mul, f2_neg, \
    f2_sqrt, B_G2

MASK64 = (1 << 64) - 1
MASK32 = (1 << 32) - 1
_SIGMA = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)


def _pcg_seed(state: int) -> bytes:
    """rand_core 0.6 seed_from_u64: eight PCG32 XSH-RR outputs."""
    state &= MASK64
    out = bytearray()
    for _ in range(8):
        state = (state * 6364136223846793005 + 11634580027462260723) & MASK64
        xs = ((state >> 18) ^ state) >> 27 & MASK32
        rot = state >> 59
        word = ((xs >> rot) | (xs << (32 - rot) & MASK32)) & MASK32 \
            if rot else xs
        out += word.to_bytes(4, "little")
    return bytes(out)


def _rotl(v: int, c: int) -> int:
    return ((v << c) | (v >> (32 - c))) & MASK32


def chacha_block(key, counter: int, stream: int, rounds: int) -> list:
    state = list(_SIGMA) + list(key) + [
        counter & MASK32, counter >> 32 & MASK32,
        stream & MASK32, stream >> 32 & MASK32]
    x = state[:]

    def qr(a, b, c, d):
        x[a] = (x[a] + x[b]) & MASK32
        x[d] = _rotl(x[d] ^ x[a], 16)
        x[c] = (x[c] + x[d]) & MASK32
        x[b] = _rotl(x[b] ^ x[c], 12)
        x[a] = (x[a] + x[b]) & MASK32
        x[d] = _rotl(x[d] ^ x[a], 8)
        x[c] = (x[c] + x[d]) & MASK32
        x[b] = _rotl(x[b] ^ x[c], 7)

    for _ in range(rounds // 2):
        qr(0, 4, 8, 12)
        qr(1, 5, 9, 13)
        qr(2, 6, 10, 14)
        qr(3, 7, 11, 15)
        qr(0, 5, 10, 15)
        qr(1, 6, 11, 12)
        qr(2, 7, 8, 13)
        qr(3, 4, 9, 14)
    return [(x[i] + state[i]) & MASK32 for i in range(16)]


class StdRng:
    def __init__(self, seed: bytes):
        self.key = [int.from_bytes(seed[4 * i:4 * i + 4], "little")
                    for i in range(8)]
        self.counter = 0
        self.buf: list = []

    @classmethod
    def seed_from_u64(cls, v: int) -> "StdRng":
        return cls(_pcg_seed(v))

    def next_u32(self) -> int:
        if not self.buf:
            self.buf = chacha_block(self.key, self.counter, 0, 12)
            self.counter = (self.counter + 1) & MASK64
        return self.buf.pop(0)

    def next_u64(self) -> int:
        lo = self.next_u32()
        return lo | (self.next_u32() << 32)


def rand_fp(rng: StdRng, modulus: int) -> int:
    """ark-ff Fp::rand as a value: four u64 limbs, low first, the top bits
    shaved, retried while >= modulus; the draw is the Montgomery form."""
    mask = (1 << modulus.bit_length()) - 1
    while True:
        v = 0
        for i in range(4):
            v |= rng.next_u64() << (64 * i)
        v &= mask
        if v < modulus:
            return v * pow(1 << 256, -1, modulus) % modulus


def rand_bool(rng: StdRng) -> bool:
    return bool(rng.next_u32() >> 31)


def rand_g1(rng: StdRng):
    while True:
        x = rand_fp(rng, P)
        greatest = rand_bool(rng)
        rhs = (x * x * x + 3) % P
        y = pow(rhs, (P + 1) // 4, P)
        if y * y % P != rhs:
            continue
        hi, lo = max(y, P - y), min(y, P - y)
        return (x, hi if greatest else lo)


def rand_g2(rng: StdRng):
    while True:
        x = (rand_fp(rng, P), rand_fp(rng, P))
        greatest = rand_bool(rng)
        y = f2_sqrt(f2_add(f2_mul(f2_mul(x, x), x), B_G2))
        if y is None:
            continue
        other = f2_neg(y)
        hi, lo = (y, other) if f2_gt(y, other) else (other, y)
        pt = G2.mul((x, hi if greatest else lo), G2_COFACTOR)
        if pt is not None:
            return pt


def toxic_waste(seed: int, domain_size: int) -> dict:
    """ark-groth16's keygen draws from StdRng(seed): alpha, beta, gamma,
    delta, the G1 and G2 generators, then t outside the domain."""
    rng = StdRng.seed_from_u64(seed)
    out = {k: rand_fp(rng, R) for k in ("alpha", "beta", "gamma", "delta")}
    out["g1"] = rand_g1(rng)
    out["g2"] = rand_g2(rng)
    while True:
        t = rand_fp(rng, R)
        if pow(t, domain_size, R) != 1:
            break
    out["t"] = t
    return out


def prove_randomness(batch_id: int) -> tuple:
    """(r, s) of a prove: two Fr draws from StdRng(batch_id)."""
    rng = StdRng.seed_from_u64(batch_id)
    r = rand_fp(rng, R)
    return r, rand_fp(rng, R)
