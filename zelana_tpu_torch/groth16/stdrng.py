"""rand 0.8-compatible StdRng (ChaCha12) with arkworks sampling semantics.

The reference's reproducibility contract is:
  - keygen: `StdRng::seed_from_u64(0)` (prover/src/bin/keygen.rs:87-91)
  - prove:  `StdRng::seed_from_u64(batch_id)`
    (core/src/sequencer/settlement/prover.rs:354)

rand 0.8's `StdRng` is `rand_chacha::ChaCha12Rng`. This module reproduces
the exact byte stream:

  * `seed_from_u64` (rand_core 0.6 default impl): a PCG32 sequence
    (MUL = 6364136223846793005, INC = 11634580027462260723) generates the
    32-byte seed four bytes at a time, advancing state BEFORE each output,
    output = XSH-RR: `rotate_right((state ^ (state >> 18)) >> 27, state >> 59)`
    serialized little-endian.
  * ChaCha12 keystream (djb variant as used by rand_chacha 0.3): state =
    [sigma consts | key words LE | 64-bit block counter | 64-bit stream=0],
    12 rounds (6 double-rounds), word-wise add of initial state, words
    emitted little-endian in block order. `next_u32` consumes one word;
    `next_u64` consumes two (lo, hi).
  * `Fr::rand` (ark-ff 0.5 `UniformRand` for `Fp`): draw 4 u64 limbs
    little-endian-limb-first via `next_u64`, mask the top limb by
    `REPR_SHAVE_BITS` (2 for BN254), retry while >= modulus. The accepted
    draw IS the Montgomery representation (arkworks samples the backing
    repr directly), so the field VALUE is draw * R^{-1} mod p --
    `rand_fr` returns the value, `rand_fr_mont` the raw repr.

Self-check: the ChaCha block function is validated against the RFC 7539
test vector at 20 rounds (same permutation core, different round count) in
tests/test_stdrng.py.
"""

from __future__ import annotations

MASK64 = (1 << 64) - 1
MASK32 = (1 << 32) - 1

_PCG_MUL = 6364136223846793005
_PCG_INC = 11634580027462260723

_SIGMA = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)


def pcg_xsh_rr(state: int) -> int:
    """PCG XSH-RR 64/32 output function (O'Neill's pcg32; the function
    rand_core 0.6's seed_from_u64 applies to each LCG state). Anchored to
    the published pcg32-demo outputs in tests/test_stdrng.py."""
    xorshifted = ((state >> 18) ^ state) >> 27 & MASK32
    rot = state >> 59
    return ((xorshifted >> rot) | (xorshifted << (32 - rot) & MASK32)
            ) & MASK32 if rot else xorshifted


def seed_from_u64(state: int) -> bytes:
    """rand_core 0.6 `SeedableRng::seed_from_u64`: PCG32-filled 32B seed."""
    state &= MASK64
    out = bytearray()
    for _ in range(8):
        state = (state * _PCG_MUL + _PCG_INC) & MASK64
        out += pcg_xsh_rr(state).to_bytes(4, "little")
    return bytes(out)


def _rotl32(v: int, c: int) -> int:
    return ((v << c) | (v >> (32 - c))) & MASK32


def chacha_block(key_words, counter: int, nonce_words, rounds: int):
    """One ChaCha block (djb layout): returns 16 output words.

    key_words: 8 u32; nonce_words: 4 u32 occupying state words 12..15 --
    callers place the 64-bit counter in words 12..13 and the stream id in
    14..15 (rand_chacha) or the IETF 32-bit counter + 96-bit nonce."""
    del counter  # carried inside nonce_words by the caller
    state = list(_SIGMA) + list(key_words) + list(nonce_words)
    x = state[:]

    def qr(a, b, c, d):
        x[a] = (x[a] + x[b]) & MASK32
        x[d] = _rotl32(x[d] ^ x[a], 16)
        x[c] = (x[c] + x[d]) & MASK32
        x[b] = _rotl32(x[b] ^ x[c], 12)
        x[a] = (x[a] + x[b]) & MASK32
        x[d] = _rotl32(x[d] ^ x[a], 8)
        x[c] = (x[c] + x[d]) & MASK32
        x[b] = _rotl32(x[b] ^ x[c], 7)

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


class ChaChaRng:
    """rand_chacha-compatible keystream reader (12 or 20 rounds)."""

    def __init__(self, seed: bytes, rounds: int = 12, stream: int = 0):
        assert len(seed) == 32
        self.key = [int.from_bytes(seed[4 * i:4 * i + 4], "little")
                    for i in range(8)]
        self.rounds = rounds
        self.stream = stream & MASK64
        self.counter = 0  # 64-bit block counter
        self._buf: list[int] = []

    def _refill(self):
        nonce = [
            self.counter & MASK32,
            (self.counter >> 32) & MASK32,
            self.stream & MASK32,
            (self.stream >> 32) & MASK32,
        ]
        self._buf = chacha_block(self.key, self.counter, nonce, self.rounds)
        self.counter = (self.counter + 1) & MASK64

    def next_u32(self) -> int:
        if not self._buf:
            self._refill()
        return self._buf.pop(0)

    def next_u64(self) -> int:
        lo = self.next_u32()
        hi = self.next_u32()
        return lo | (hi << 32)

    def fill_bytes(self, n: int) -> bytes:
        out = bytearray()
        while len(out) < n:
            out += self.next_u32().to_bytes(4, "little")
        return bytes(out[:n])


class StdRng(ChaChaRng):
    """rand 0.8 `StdRng` (= ChaCha12Rng)."""

    def __init__(self, seed: bytes):
        super().__init__(seed, rounds=12)

    @classmethod
    def seed_from_u64(cls, v: int) -> "StdRng":
        return cls(seed_from_u64(v))


# ---------------------------------------------------------------------------
# arkworks UniformRand sampling
# ---------------------------------------------------------------------------


def rand_bigint256(rng) -> int:
    """BigInt::<4>::rand: 4 u64 limbs, least-significant limb drawn first."""
    v = 0
    for i in range(4):
        v |= rng.next_u64() << (64 * i)
    return v


def rand_fp_mont(rng, modulus: int) -> int:
    """ark-ff `Fp::rand`: returns the raw (Montgomery) repr < modulus."""
    shave = 4 * 64 - modulus.bit_length()
    mask = (1 << (256 - shave)) - 1
    while True:
        v = rand_bigint256(rng) & mask
        if v < modulus:
            return v


def rand_fp(rng, modulus: int, r_word: int | None = None) -> int:
    """ark-ff `Fp::rand` as a field VALUE: repr * R^{-1} mod p, where R is
    the Montgomery constant 2^256 (pass r_word to override)."""
    r = r_word if r_word is not None else (1 << 256) % modulus
    repr_ = rand_fp_mont(rng, modulus)
    rinv = pow(r, -1, modulus)
    return repr_ * rinv % modulus


def rand_bool(rng) -> bool:
    """rand 0.8 `Standard` bool: the most significant bit of next_u32."""
    return bool(rng.next_u32() & (1 << 31))


def rand_g1(rng):
    """ark-ec `Projective::<G1>::rand`: sample x = Fq::rand and a
    `greatest` bool until x lands on the curve, pick the lexicographically
    greater/lesser root, multiply by the cofactor (1 for BN254 G1).
    Returns an affine python point."""
    from ..curves import g1 as G1
    from ..fields.bn254 import P

    while True:
        x = rand_fp(rng, P)
        greatest = rand_bool(rng)
        rhs = (x * x % P * x + 3) % P
        y = pow(rhs, (P + 1) // 4, P)
        if y * y % P != rhs:
            continue
        y_other = P - y
        hi, lo = (y, y_other) if y > y_other else (y_other, y)
        pt = (x, hi if greatest else lo)
        assert G1.is_on_curve(pt)
        return pt


def rand_g2(rng):
    """ark-ec `Projective::<G2>::rand` for BN254 G2: x = Fq2::rand
    (c0 then c1), `greatest` root by ark's QuadExtField ordering (compare
    c1 first, then c0), then clear the cofactor."""
    from ..curves import g2 as G2
    from ..fields import tower as tw
    from ..fields.bn254 import P

    # b' = 3 / (9 + u) on the twist
    b = tw.fq2_scale(tw.fq2_inv((9, 1)), 3)
    # BN254 G2 cofactor: (36x^4 + 36x^3 + 30x^2 + 6x + 1) with x the BN
    # parameter; equals #E'(Fq) / r
    cof = 21888242871839275222246405745257275088844257914179612981679871602714643921549
    while True:
        x = (rand_fp(rng, P), rand_fp(rng, P))
        greatest = rand_bool(rng)
        rhs = tw.fq2_add(tw.fq2_mul(tw.fq2_sqr(x), x), b)
        y = tw.fq2_sqrt(rhs)
        if y is None:
            continue
        y_other = tw.fq2_neg(y)
        hi, lo = ((y, y_other) if tw.fq2_cmp_gt(y, y_other)
                  else (y_other, y))
        pt = G2.mul((x, hi if greatest else lo), cof)
        if pt is None:
            continue
        assert G2.is_on_curve(pt) and G2.in_subgroup(pt)
        return pt
