"""Radix-2 evaluation domain over BN254 Fr (host-side semantics + golden FFT).

Matches ark-poly =0.5.0 `Radix2EvaluationDomain` as used by ark-groth16's
R1CS-to-QAP reduction (the engine invoked at
core/src/sequencer/settlement/prover.rs:408):

- domain size = next power of two >= requested
- group_gen = TWO_ADIC_ROOT_OF_UNITY ^ (2^(TWO_ADICITY - log2(n)))
- fft: natural-order evaluations  evals[i] = f(g^i)
- coset fft uses offset F::GENERATOR = 5
- vanishing polynomial Z(tau) = tau^n - 1

The golden FFT here is Python-int based, used for tests and tiny domains; the
device path is ops/ntt.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

from ..fields.bn254 import R as FR, FR_TWO_ADICITY, FR_TWO_ADIC_ROOT, FR_GENERATOR


@dataclass(frozen=True)
class Domain:
    size: int  # power of two
    log_size: int
    group_gen: int
    group_gen_inv: int
    size_inv: int
    coset_offset: int = FR_GENERATOR

    @staticmethod
    @lru_cache(maxsize=None)
    def new(min_size: int) -> "Domain":
        log_n = max(1, (min_size - 1).bit_length())
        n = 1 << log_n
        assert log_n <= FR_TWO_ADICITY
        g = pow(FR_TWO_ADIC_ROOT, 1 << (FR_TWO_ADICITY - log_n), FR)
        return Domain(
            size=n,
            log_size=log_n,
            group_gen=g,
            group_gen_inv=pow(g, FR - 2, FR),
            size_inv=pow(n, FR - 2, FR),
        )

    def elements(self):
        acc = 1
        for _ in range(self.size):
            yield acc
            acc = acc * self.group_gen % FR

    def evaluate_vanishing_polynomial(self, tau: int) -> int:
        return (pow(tau, self.size, FR) - 1) % FR

    # -- golden transforms (Python ints) -----------------------------------

    def _fft_in_place(self, values, omega):
        n = self.size
        vals = list(values) + [0] * (n - len(values))
        assert len(vals) == n
        # bit reverse
        j = 0
        for i in range(1, n):
            bit = n >> 1
            while j & bit:
                j ^= bit
                bit >>= 1
            j |= bit
            if i < j:
                vals[i], vals[j] = vals[j], vals[i]
        length = 2
        while length <= n:
            wlen = pow(omega, n // length, FR)
            for start in range(0, n, length):
                w = 1
                for k in range(length // 2):
                    u = vals[start + k]
                    v = vals[start + k + length // 2] * w % FR
                    vals[start + k] = (u + v) % FR
                    vals[start + k + length // 2] = (u - v) % FR
                    w = w * wlen % FR
            length <<= 1
        return vals

    def fft(self, coeffs):
        return self._fft_in_place(coeffs, self.group_gen)

    def ifft(self, evals):
        vals = self._fft_in_place(evals, self.group_gen_inv)
        return [v * self.size_inv % FR for v in vals]

    def coset_fft(self, coeffs):
        g = self.coset_offset
        scaled, acc = [], 1
        coeffs = list(coeffs) + [0] * (self.size - len(coeffs))
        for c in coeffs:
            scaled.append(c * acc % FR)
            acc = acc * g % FR
        return self.fft(scaled)

    def coset_ifft(self, evals):
        coeffs = self.ifft(evals)
        ginv = pow(self.coset_offset, FR - 2, FR)
        out, acc = [], 1
        for c in coeffs:
            out.append(c * acc % FR)
            acc = acc * ginv % FR
        return out

    def evaluate_vanishing_on_coset(self) -> int:
        """Z(g*w^i) = g^n - 1 is constant on the coset."""
        return (pow(self.coset_offset, self.size, FR) - 1) % FR
