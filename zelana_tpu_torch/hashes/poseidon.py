"""Poseidon sponge (golden, Python ints) matching ark-crypto-primitives 0.5.

Duplex sponge semantics reproduce arkworks `PoseidonSponge` exactly (state
layout [capacity | rate], permute-on-overflow absorb, permute on the
absorb->squeeze transition), because the reference circuit hashes whole
absorb/squeeze sequences, not bare permutations (prover/src/l2_circuit.rs:301-339).

Three configurations are used across the reference and are all provided here:

- ``bn254_config()``:   BN254 Fr, 8 full / 56 partial rounds
  (prover/src/l2_circuit.rs:68-83, prover/src/circuit/poseidon.rs:12-41)
- ``bn254_config_57()``: BN254 Fr, 8 / 57 -- the shielded circuit's local
  config (prover/src/circuit/shielded.rs:365-368)
- ``bls12_381_config()``: BLS12-381 Fr, 8 / 57 -- the privacy SDK note stack
  (sdk/privacy/src/commitment.rs:130-158, merkle.rs:121-124)

Only the host sponge is needed here: the L2 circuit's witness generation.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import List, Sequence

from .grain import find_poseidon_ark_and_mds
from ..fields.bn254 import R as BN254_FR

# BLS12-381 scalar field modulus
BLS12_381_FR = 52435875175126190479447740508185965837690552500527637822603658699938581184513


@dataclass(frozen=True)
class PoseidonConfig:
    modulus: int
    full_rounds: int
    partial_rounds: int
    alpha: int
    ark: tuple  # (full+partial) x (rate+capacity)
    mds: tuple  # (rate+capacity) x (rate+capacity)
    rate: int
    capacity: int

    @property
    def width(self) -> int:
        return self.rate + self.capacity


@lru_cache(maxsize=None)
def _make_config(modulus: int, prime_bits: int, full: int, partial: int) -> PoseidonConfig:
    ark, mds = find_poseidon_ark_and_mds(modulus, prime_bits, 2, full, partial, 0)
    return PoseidonConfig(modulus, full, partial, 5, ark, mds, rate=2, capacity=1)


def bn254_config() -> PoseidonConfig:
    return _make_config(BN254_FR, 254, 8, 56)


def bn254_config_57() -> PoseidonConfig:
    return _make_config(BN254_FR, 254, 8, 57)


def bls12_381_config() -> PoseidonConfig:
    return _make_config(BLS12_381_FR, 255, 8, 57)


def permute(state: List[int], cfg: PoseidonConfig) -> List[int]:
    """One Poseidon permutation (returns a new state list)."""
    p = cfg.modulus
    width = cfg.width
    state = [s % p for s in state]
    half_full = cfg.full_rounds // 2
    total = cfg.full_rounds + cfg.partial_rounds

    for rnd in range(total):
        is_full = rnd < half_full or rnd >= half_full + cfg.partial_rounds
        ark_row = cfg.ark[rnd]
        state = [(state[i] + ark_row[i]) % p for i in range(width)]
        if is_full:
            state = [pow(s, cfg.alpha, p) for s in state]
        else:
            state[0] = pow(state[0], cfg.alpha, p)
        state = [
            sum(cfg.mds[i][j] * state[j] for j in range(width)) % p
            for i in range(width)
        ]
    return state


class PoseidonSponge:
    """arkworks-compatible duplex sponge (capacity-first state layout)."""

    def __init__(self, cfg: PoseidonConfig):
        self.cfg = cfg
        self.state = [0] * cfg.width
        self.mode = "absorbing"
        self.index = 0  # next absorb or squeeze index within the rate

    def _permute(self):
        self.state = permute(self.state, self.cfg)

    def absorb(self, elements: Sequence[int]):
        elements = [e % self.cfg.modulus for e in elements]
        if not elements:
            return
        if self.mode == "absorbing":
            idx = self.index
            if idx == self.cfg.rate:
                self._permute()
                idx = 0
        else:
            self._permute()
            idx = 0
            self.mode = "absorbing"
        self._absorb_internal(idx, elements)

    def _absorb_internal(self, rate_start: int, elements):
        cap = self.cfg.capacity
        rem = list(elements)
        while True:
            if rate_start + len(rem) <= self.cfg.rate:
                for i, e in enumerate(rem):
                    self.state[cap + rate_start + i] = (
                        self.state[cap + rate_start + i] + e
                    ) % self.cfg.modulus
                self.index = rate_start + len(rem)
                return
            n = self.cfg.rate - rate_start
            for i in range(n):
                self.state[cap + rate_start + i] = (
                    self.state[cap + rate_start + i] + rem[i]
                ) % self.cfg.modulus
            self._permute()
            rem = rem[n:]
            rate_start = 0

    def squeeze_field_elements(self, num: int) -> List[int]:
        if num == 0:
            return []
        if self.mode == "absorbing":
            self._permute()
            idx = 0
            self.mode = "squeezing"
        else:
            idx = self.index
            if idx == self.cfg.rate:
                self._permute()
                idx = 0
        return self._squeeze_internal(idx, num)

    def _squeeze_internal(self, rate_start: int, num: int) -> List[int]:
        cap = self.cfg.capacity
        out: List[int] = []
        remaining = num
        while True:
            if rate_start + remaining <= self.cfg.rate:
                out.extend(
                    self.state[cap + rate_start + i] for i in range(remaining)
                )
                self.index = rate_start + remaining
                return out
            n = self.cfg.rate - rate_start
            out.extend(self.state[cap + rate_start + i] for i in range(n))
            if remaining != self.cfg.rate:
                self._permute()
            remaining -= n
            rate_start = 0


def poseidon_hash(cfg: PoseidonConfig, inputs: Sequence[int]) -> int:
    """absorb(inputs); squeeze(1) -- the ubiquitous reference pattern."""
    sponge = PoseidonSponge(cfg)
    sponge.absorb(inputs)
    return sponge.squeeze_field_elements(1)[0]
