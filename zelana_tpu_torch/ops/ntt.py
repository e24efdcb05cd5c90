"""Radix-2 NTT / iNTT over BN254 Fr on (8, n) Montgomery words.

The same transforms as ark-poly's ``Radix2EvaluationDomain`` fft / ifft and
their coset variants (poly/domain.py has the semantics): decimation in time,
a bit-reversal gather, then log n butterfly stages, each one launch of the
butterfly kernel (ops/field_kernels.py). The gather and the stage reshapes
are torch indexing, as the JAX package leaves them to XLA.

``plain=True`` runs the same chain through the kernels' plain versions
wherever the tensors live; the card's result is held against it.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np
import torch

from ..fields.bn254 import R as FR_MOD, FR_GENERATOR
from ..poly.domain import Domain
from . import field_kernels as FK
from . import limbs as L


def _powers_mont(base: int, count: int) -> np.ndarray:
    """(8, count) words of base^j in Montgomery form, by running products:
    mont(x * base) = mont(x) * base mod r, so no per-element pow."""
    out = []
    x = L.MONT_R % FR_MOD
    for _ in range(count):
        out.append(x)
        x = x * base % FR_MOD
    return L.to_words(out)


@dataclass
class NttPlan:
    domain: Domain
    bitrev: np.ndarray  # (n,) int64 permutation
    twiddles: np.ndarray  # (8, n/2) words of omega^k, forward
    twiddles_inv: np.ndarray  # (8, n/2) words of omega^-k
    n_inv: np.ndarray  # (8,) words of 1/n
    coset: np.ndarray  # (8, n) words of g^j
    coset_inv: np.ndarray  # (8, n) words of g^-j
    _dev: dict = field(default_factory=dict, repr=False)

    @property
    def n(self):
        return self.domain.size

    def on(self, device: torch.device) -> dict:
        """The tables as tensors on `device`, uploaded once."""
        key = str(device)
        if key not in self._dev:
            self._dev[key] = {
                "bitrev": torch.from_numpy(self.bitrev).to(device),
                "tw": L.to_tensor(self.twiddles, device),
                "twi": L.to_tensor(self.twiddles_inv, device),
                "coset": L.to_tensor(self.coset, device),
                "coset_inv": L.to_tensor(self.coset_inv, device),
                "n_inv": L.to_tensor(self.n_inv.reshape(L.NWORDS, 1), device),
            }
        return self._dev[key]


@functools.lru_cache(maxsize=None)
def make_plan(min_size: int) -> NttPlan:
    dom = Domain.new(min_size)
    n, log_n = dom.size, dom.log_size
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    g = FR_GENERATOR
    return NttPlan(
        domain=dom,
        bitrev=rev,
        twiddles=_powers_mont(dom.group_gen, n // 2),
        twiddles_inv=_powers_mont(dom.group_gen_inv, n // 2),
        n_inv=L.encode_mont([dom.size_inv], L.FR)[:, 0],
        coset=_powers_mont(g, n),
        coset_inv=_powers_mont(pow(g, FR_MOD - 2, FR_MOD), n),
    )


def _ntt_core(x: torch.Tensor, top: torch.Tensor, bitrev: torch.Tensor,
              plain: bool) -> torch.Tensor:
    """x: (8, n) words -> (8, n) words of the transform (natural order).
    `top` holds w^k for k < n/2; stage s uses every (n / 2^(s+1))-th."""
    bfly = FK.butterfly_plain if plain else FK.butterfly
    n = x.shape[1]
    x = x.index_select(1, bitrev)
    for s in range(n.bit_length() - 1):
        half = 1 << s
        groups = n // (2 * half)
        x4 = x.view(L.NWORDS, groups, 2, half)
        a = x4[:, :, 0, :].contiguous().view(L.NWORDS, n // 2)
        b = x4[:, :, 1, :].contiguous().view(L.NWORDS, n // 2)
        tw = top[:, ::groups][:, None, :half].expand(L.NWORDS, groups, half)
        tw = tw.contiguous().view(L.NWORDS, n // 2)
        even, odd = bfly(a, b, tw, L.FR)
        x = torch.stack([even.view(L.NWORDS, groups, half),
                         odd.view(L.NWORDS, groups, half)], dim=2)
        x = x.view(L.NWORDS, n)
    return x


def _mul(a, b, plain: bool):
    return (FK.mont_mul_plain if plain else FK.mont_mul)(a, b, L.FR)


def ntt(x: torch.Tensor, plan: NttPlan, plain: bool = False) -> torch.Tensor:
    """Forward NTT: coefficients -> evaluations at powers of group_gen."""
    t = plan.on(x.device)
    return _ntt_core(x, t["tw"], t["bitrev"], plain)


def intt(x: torch.Tensor, plan: NttPlan, plain: bool = False) -> torch.Tensor:
    """Inverse NTT: evaluations -> coefficients."""
    t = plan.on(x.device)
    y = _ntt_core(x, t["twi"], t["bitrev"], plain)
    return _mul(y, t["n_inv"].expand(L.NWORDS, plan.n).contiguous(), plain)


def coset_ntt(x: torch.Tensor, plan: NttPlan,
              plain: bool = False) -> torch.Tensor:
    """Evaluate on the coset g * <omega> (g = 5, matching ark-poly)."""
    return ntt(_mul(x, plan.on(x.device)["coset"], plain), plan, plain)


def coset_intt(x: torch.Tensor, plan: NttPlan,
               plain: bool = False) -> torch.Tensor:
    return _mul(intt(x, plan, plain), plan.on(x.device)["coset_inv"], plain)
