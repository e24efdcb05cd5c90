"""Poseidon sponge gadget over FpVar (constraint-emitting twin of
zelana_tpu_torch.hashes.poseidon.PoseidonSponge).

Mirrors ark-crypto-primitives `PoseidonSpongeVar` (the in-circuit sponge the
reference uses throughout L2BlockCircuit, prover/src/l2_circuit.rs:301-339):
same duplex state machine, same round structure, s-box x^5 costing 3
constraints per variable element and 0 per constant element.
"""

from __future__ import annotations

from typing import List, Sequence

from ..hashes.poseidon import PoseidonConfig
from .system import ConstraintSystem, FpVar


class PoseidonSpongeVar:
    def __init__(self, cs: ConstraintSystem, cfg: PoseidonConfig):
        assert cfg.modulus == cs.constant(0).value + cfg.modulus  # same field
        self.cs = cs
        self.cfg = cfg
        self.state: List[FpVar] = [cs.constant(0) for _ in range(cfg.width)]
        self.mode = "absorbing"
        self.index = 0

    # -- permutation --------------------------------------------------------

    def _permute(self):
        cfg = self.cfg
        state = list(self.state)
        half_full = cfg.full_rounds // 2
        total = cfg.full_rounds + cfg.partial_rounds
        for rnd in range(total):
            is_full = rnd < half_full or rnd >= half_full + cfg.partial_rounds
            ark_row = cfg.ark[rnd]
            state = [s.add_constant(ark_row[i]) for i, s in enumerate(state)]
            if is_full:
                state = [s.pow5() for s in state]
            else:
                state[0] = state[0].pow5()
            state = [
                FpVar.combine(
                    self.cs,
                    [(state[j], cfg.mds[i][j]) for j in range(cfg.width)],
                )
                for i in range(cfg.width)
            ]
        self.state = state

    # -- duplex -------------------------------------------------------------

    def absorb(self, elements: Sequence[FpVar]):
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
        self._absorb_internal(idx, list(elements))

    def _absorb_internal(self, rate_start: int, rem: List[FpVar]):
        cap = self.cfg.capacity
        while True:
            if rate_start + len(rem) <= self.cfg.rate:
                for i, e in enumerate(rem):
                    self.state[cap + rate_start + i] = (
                        self.state[cap + rate_start + i] + e
                    )
                self.index = rate_start + len(rem)
                return
            n = self.cfg.rate - rate_start
            for i in range(n):
                self.state[cap + rate_start + i] = (
                    self.state[cap + rate_start + i] + rem[i]
                )
            self._permute()
            rem = rem[n:]
            rate_start = 0

    def squeeze(self, num: int) -> List[FpVar]:
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

    def _squeeze_internal(self, rate_start: int, num: int) -> List[FpVar]:
        cap = self.cfg.capacity
        out: List[FpVar] = []
        remaining = num
        while True:
            if rate_start + remaining <= self.cfg.rate:
                out.extend(self.state[cap + rate_start + i] for i in range(remaining))
                self.index = rate_start + remaining
                return out
            n = self.cfg.rate - rate_start
            out.extend(self.state[cap + rate_start + i] for i in range(n))
            if remaining != self.cfg.rate:
                self._permute()
            remaining -= n
            rate_start = 0


def poseidon_hash_var(cs: ConstraintSystem, cfg: PoseidonConfig,
                      inputs: Sequence[FpVar]) -> FpVar:
    sponge = PoseidonSpongeVar(cs, cfg)
    sponge.absorb(list(inputs))
    return sponge.squeeze(1)[0]
