"""Grain-LFSR Poseidon parameter generation.

Re-implements the parameter derivation used by ark-crypto-primitives =0.5.0
`find_poseidon_ark_and_mds` (the reference circuits generate their round
constants and MDS matrices at runtime with exactly this procedure:
prover/src/l2_circuit.rs:75-81, sdk/privacy/src/commitment.rs:141-147).

The Grain LFSR is the one from the Poseidon reference implementation:
an 80-bit state seeded from (field type, s-box, field bits, state size,
full rounds, partial rounds), 160 discarded warm-up updates, and output
bits sampled in pairs (emit the second bit of a pair only when the first
bit is 1).

Round constants are sampled by rejection (retry until the value is below the
modulus); MDS is a Cauchy matrix mds[i][j] = 1/(x_i + y_j) from mod-p
sampled vectors.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Tuple


class GrainLFSR:
    __slots__ = ("state", "head", "prime_num_bits")

    def __init__(
        self,
        is_sbox_an_inverse: bool,
        prime_num_bits: int,
        state_len: int,
        num_full_rounds: int,
        num_partial_rounds: int,
    ):
        state = [False] * 80
        # b0..b1: field type (prime field = 1)
        state[1] = True
        # b2..b5: s-box exponent descriptor (x^alpha = 0, inverse = 1)
        if is_sbox_an_inverse:
            state[5] = True

        def fill(lo: int, hi: int, value: int):
            cur = value
            for i in range(hi, lo - 1, -1):
                state[i] = (cur & 1) == 1
                cur >>= 1

        fill(6, 17, prime_num_bits)
        fill(18, 29, state_len)
        fill(30, 39, num_full_rounds)
        fill(40, 49, num_partial_rounds)
        for i in range(50, 80):
            state[i] = True

        self.state = state
        self.head = 0
        self.prime_num_bits = prime_num_bits
        for _ in range(160):
            self._update()

    def _update(self) -> bool:
        s, h = self.state, self.head
        new_bit = (
            s[(h + 62) % 80]
            ^ s[(h + 51) % 80]
            ^ s[(h + 38) % 80]
            ^ s[(h + 23) % 80]
            ^ s[(h + 13) % 80]
            ^ s[h]
        )
        s[h] = new_bit
        self.head = (h + 1) % 80
        return new_bit

    def get_bits(self, num_bits: int) -> List[bool]:
        res = []
        for _ in range(num_bits):
            new_bit = self._update()
            while not new_bit:
                self._update()  # discard the second bit of the pair
                new_bit = self._update()
            res.append(self._update())
        return res

    def _next_int(self) -> int:
        """prime_num_bits sampled bits, first-generated bit most significant."""
        value = 0
        for bit in self.get_bits(self.prime_num_bits):
            value = (value << 1) | int(bit)
        return value

    def get_field_elements_rejection_sampling(self, modulus: int, num_elems: int) -> List[int]:
        res = []
        for _ in range(num_elems):
            while True:
                v = self._next_int()
                if v < modulus:
                    res.append(v)
                    break
        return res

    def get_field_elements_mod_p(self, modulus: int, num_elems: int) -> List[int]:
        return [self._next_int() % modulus for _ in range(num_elems)]


@lru_cache(maxsize=None)
def find_poseidon_ark_and_mds(
    modulus: int,
    prime_bits: int,
    rate: int,
    full_rounds: int,
    partial_rounds: int,
    skip_matrices: int = 0,
) -> Tuple[tuple, tuple]:
    """Returns (ark, mds) as nested tuples of ints, matching arkworks."""
    t = rate + 1  # capacity is 1 in this derivation
    lfsr = GrainLFSR(False, prime_bits, t, full_rounds, partial_rounds)

    ark = tuple(
        tuple(lfsr.get_field_elements_rejection_sampling(modulus, t))
        for _ in range(full_rounds + partial_rounds)
    )

    for _ in range(skip_matrices):
        lfsr.get_field_elements_mod_p(modulus, 2 * t)

    xs = lfsr.get_field_elements_mod_p(modulus, t)
    ys = lfsr.get_field_elements_mod_p(modulus, t)
    mds = tuple(
        tuple(pow(xs[i] + ys[j], modulus - 2, modulus) for j in range(t))
        for i in range(t)
    )
    return ark, mds
