"""Radix-2 NTT / iNTT over BN254 Fr on (8, n) Montgomery words.

The same transforms as ark-poly's ``Radix2EvaluationDomain`` fft / ifft and
their coset variants (poly/domain.py has the semantics): decimation in time,
a bit-reversal gather, then log n butterfly stages.

On the card a transform is one launch of the pass kernel
(csrc/ntt_kernels.cu) per pass: each runs stages [s0, s1) of the DIT
network on tiles of up to 2^11 elements in shared memory, and
``default_split`` picks the passes from log n (three at 2^13 and 2^21).
The first pass gathers its inputs in bit-reversed order and applies the
prologue at the source index (x_j g^j for the coset NTT, (a_j b_j - c_j)
/ Z for the quotient); the last applies the epilogue
at the output index (1/n for the iNTT, 1/n g^-j for the coset iNTT). Later
passes work in place on the output buffer; the inputs are never written.

``ntt_pass_plain`` is the same pass in plain torch. Tensors on the CPU and
``plain=True`` run it, as one pass of every stage unless a split is forced
(``transform_split``); nothing on the CUDA path does.

One transform block-sharded over D ranks (parallel/sharded.py): each rank
runs the first log(n/D) stages on its block with the pass kernel
(``block_stages``), then the last log D stages one at a time against the
partner rank's block (``ntt_cross``: CUDA kernel ``ntt_cross_kernel``, one
thread an element, the fused counterpart of the JAX sharded NTT's
``L.mont_mul`` and add / sub; plain version ``ntt_cross_plain``).
"""

from __future__ import annotations

import ctypes
import functools
import threading
from dataclasses import dataclass, field

import numpy as np
import torch

from ..fields.bn254 import R as FR_MOD, FR_GENERATOR
from ..poly.domain import Domain
from . import cuda
from . import field_kernels as FK
from . import limbs as L

# the pass kernel's largest tile, 2^TILE_BITS elements (csrc/ntt_kernels.cu
# kNttTileBits); its launcher refuses a pass that does not fit a tile
TILE_BITS = 11

PRO_NONE, PRO_COSET, PRO_QUOTIENT = 0, 1, 2
EPI_NONE, EPI_SCALAR, EPI_TABLE = 0, 1, 2


def _powers_mont(base: int, count: int, start: int = 1) -> np.ndarray:
    """(8, count) words of start base^j in Montgomery form, by running
    products: mont(x * base) = mont(x) * base mod r, so no per-element
    pow."""
    out = []
    x = start * L.MONT_R % FR_MOD
    for _ in range(count):
        out.append(x)
        x = x * base % FR_MOD
    return L.to_words(out)


def _stage_columns(n: int) -> np.ndarray:
    """Column 2^s + k of the stage-major twiddle table is column k n /
    2^(s+1) of the (8, n/2) table of w^k: w_(2^(s+1))^k; column 0 is w^0."""
    idx = np.zeros(n, dtype=np.int64)
    for s in range(n.bit_length() - 1):
        idx[1 << s:2 << s] = np.arange(1 << s) * (n >> (s + 1))
    return idx


@dataclass
class NttPlan:
    domain: Domain
    twiddles: np.ndarray  # (8, n/2) words of omega^k, forward
    twiddles_inv: np.ndarray  # (8, n/2) words of omega^-k
    n_inv: np.ndarray  # (8,) words of 1/n
    coset: np.ndarray  # (8, n) words of g^j
    coset_inv_n: np.ndarray  # (8, n) words of 1/n g^-j
    z_inv: np.ndarray  # (8,) words of 1/Z on the coset, Z = g^n - 1
    _dev: dict = field(default_factory=dict, repr=False)
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    @property
    def n(self):
        return self.domain.size

    def on(self, device: torch.device) -> dict:
        """The tables the passes read, as tensors on `device`, made once:
        the stage-major twiddles ("tw_st", "twi_st", gathered from the
        twiddle tables on the device), g^j ("coset") and 1/n g^-j
        ("coset_inv_n"). Threads that ask for a device first wait for one
        upload."""
        key = str(device)
        with self._lock:
            if key in self._dev:
                return self._dev[key]
            cols = torch.from_numpy(_stage_columns(self.n)).to(device)
            self._dev[key] = {
                "tw_st": L.to_tensor(self.twiddles, device).index_select(
                    1, cols),
                "twi_st": L.to_tensor(self.twiddles_inv, device).index_select(
                    1, cols),
                "coset": L.to_tensor(self.coset, device),
                "coset_inv_n": L.to_tensor(self.coset_inv_n, device),
            }
            return self._dev[key]


_PLAN_LOCKS: dict = {}  # min_size -> the lock its first build holds
_PLAN_LOCKS_LOCK = threading.Lock()


def make_plan(min_size: int) -> NttPlan:
    """The plan of the domain of at least `min_size` points, built once:
    threads that ask for a size while its host tables are being built (a
    few seconds at 2^21) wait for that build instead of making their
    own."""
    with _PLAN_LOCKS_LOCK:
        lock = _PLAN_LOCKS.setdefault(min_size, threading.Lock())
    with lock:
        return _build_plan(min_size)


@functools.lru_cache(maxsize=None)
def _build_plan(min_size: int) -> NttPlan:
    dom = Domain.new(min_size)
    n = dom.size
    g = FR_GENERATOR
    z_inv = pow(dom.evaluate_vanishing_on_coset(), FR_MOD - 2, FR_MOD)
    return NttPlan(
        domain=dom,
        twiddles=_powers_mont(dom.group_gen, n // 2),
        twiddles_inv=_powers_mont(dom.group_gen_inv, n // 2),
        n_inv=L.encode_mont([dom.size_inv], L.FR)[:, 0],
        coset=_powers_mont(g, n),
        coset_inv_n=_powers_mont(pow(g, FR_MOD - 2, FR_MOD), n,
                                 dom.size_inv),
        z_inv=L.encode_mont([z_inv], L.FR)[:, 0],
    )


# ---------------------------------------------------------------------------
# passes
# ---------------------------------------------------------------------------


def default_split(log_n: int) -> list:
    """Stages a pass of a 2^log_n transform on the card: as few passes as
    cover log_n with tiles of at most 2^min(TILE_BITS, log_n - 5) elements
    (32 blocks a pass or more, to spread a short transform's chains of
    dependent products over the SMs), a tile holding 8 DIT sets of the
    pass's stages (neighbours in a 32-byte sector of a word row), but at
    least 4 stages a pass, as even as they come, the longer first: 2^13
    [5, 4, 4], 2^21 [7, 7, 7]. On an H100 2^13 took 0.0166 ms as [5, 4, 4] and
    0.0258 ms as [7, 6] (PERF.md §6)."""
    per = max(4, min(TILE_BITS, log_n - 5) - 3)
    p = -(-log_n // per)
    q, r = divmod(log_n, p)
    return [q + 1] * r + [q] * (p - r)


def _passes(log_n: int, split) -> list:
    """[(s0, s1)] of a split; raises unless its parts cover log_n (the
    pass kernel's launcher refuses a pass that does not fit a tile)."""
    if sum(split) != log_n or min(split) < 1:
        raise ValueError(f"split {split} does not cover {log_n} stages")
    bounds = np.cumsum([0, *split]).tolist()
    return list(zip(bounds[:-1], bounds[1:]))


def _bitrev(n: int, device) -> torch.Tensor:
    """The DIT's input permutation: element j from brev_(log n)(j)."""
    idx = torch.arange(n, device=device)
    rev = torch.zeros_like(idx)
    for b in range(n.bit_length() - 1):
        rev |= ((idx >> b) & 1) << (n.bit_length() - 2 - b)
    return rev


def _scalar(words, device) -> torch.Tensor:
    return L.to_tensor(np.asarray(words, np.uint32).reshape(L.NWORDS, 1),
                       device)


def ntt_pass_plain(xs, twst, s0: int, s1: int, pro: int = PRO_NONE,
                   ptab=None, pk=None, epi: int = EPI_NONE, etab=None,
                   ek=None) -> torch.Tensor:
    """Stages [s0, s1) of the DIT network: the pass kernel's plain version.
    xs: [x], or [a, b, c] for the quotient prologue, (8, n) words; twst:
    the (8, n) stage-major twiddles. s0 = 0 applies the prologue (pro:
    PRO_COSET, x g^j with g^j from ptab; PRO_QUOTIENT, (a b - c) pk with pk
    (8,) words) and gathers in bit-reversed order; s1 = log n applies the
    epilogue (EPI_SCALAR: times ek, (8,) words; EPI_TABLE: times etab).
    Returns a new tensor."""
    x = xs[0]
    n = x.shape[1]
    mul = functools.partial(FK.mont_mul_plain, spec=L.FR)
    if s0 == 0:
        if pro == PRO_QUOTIENT:
            x = L.sub(mul(x, xs[1]), xs[2], L.FR)
        if pro != PRO_NONE:
            x = mul(x, ptab if pro == PRO_COSET else _scalar(pk, x.device))
        x = x.index_select(1, _bitrev(n, x.device))
    for s in range(s0, s1):
        half = 1 << s
        groups = n // (2 * half)
        x4 = x.view(L.NWORDS, groups, 2, half)
        a = x4[:, :, 0, :].reshape(L.NWORDS, n // 2)
        b = x4[:, :, 1, :].reshape(L.NWORDS, n // 2)
        tw = twst[:, half:2 * half][:, None, :].expand(L.NWORDS, groups, half)
        even, odd = FK.butterfly_plain(a, b, tw.reshape(L.NWORDS, n // 2),
                                       L.FR)
        x = torch.stack([even.view(L.NWORDS, groups, half),
                         odd.view(L.NWORDS, groups, half)], dim=2)
        x = x.view(L.NWORDS, n)
    if s1 == n.bit_length() - 1 and epi != EPI_NONE:
        x = mul(x, _scalar(ek, x.device) if epi == EPI_SCALAR else etab)
    return x


def _host_words(words):
    return None if words is None else (ctypes.c_uint32 * L.NWORDS)(
        *np.asarray(words, np.uint32).tolist())


def ntt_pass(xs, twst, s0: int, s1: int, pro: int = PRO_NONE, ptab=None,
             pk=None, epi: int = EPI_NONE, etab=None,
             ek=None) -> torch.Tensor:
    """ntt_pass_plain's pass by the pass kernel on CUDA tensors (the plain
    version on CPU tensors). A first pass (s0 = 0) writes a new tensor; a
    later one runs in place on xs[0] and returns it."""
    tabs = [t for t in (ptab, etab) if t is not None]
    if all(t.device.type == "cpu" for t in [*xs, twst, *tabs]):
        return ntt_pass_plain(xs, twst, s0, s1, pro, ptab, pk, epi, etab, ek)
    n = xs[0].shape[1]
    ops = [*xs, twst, *tabs]
    dev = cuda.check(ops, [(L.NWORDS, n)] * len(ops), "ntt_pass")
    out = torch.empty_like(xs[0]) if s0 == 0 else xs[0]
    ptr = [t.data_ptr() for t in xs] + [None] * (3 - len(xs))
    cuda.launch("ntt_kernels", "zt_ntt_pass", *ptr, out.data_ptr(),
                twst.data_ptr(), ptab.data_ptr() if ptab is not None else None,
                etab.data_ptr() if etab is not None else None,
                _host_words(pk), _host_words(ek), n, s0, s1, pro, epi,
                device=dev)
    cuda.count("ntt_pass")
    return out


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------

# kind -> (inverse twiddles, prologue, epilogue)
KINDS = {
    "ntt": (False, PRO_NONE, EPI_NONE),
    "intt": (True, PRO_NONE, EPI_SCALAR),
    "coset_ntt": (False, PRO_COSET, EPI_NONE),
    "coset_intt": (True, PRO_NONE, EPI_TABLE),
    "quotient": (True, PRO_QUOTIENT, EPI_TABLE),
}


def _run_passes(xs, twst, log_n: int, split, plain: bool, pro=PRO_NONE,
                ptab=None, pk=None, epi=EPI_NONE, etab=None,
                ek=None) -> torch.Tensor:
    """The passes of one transform of 2^log_n elements over `twst`, the
    prologue in the first, the epilogue in the last."""
    if split is None:
        split = [log_n] if plain else default_split(log_n)
    run = ntt_pass_plain if plain else ntt_pass
    y = None
    for s0, s1 in _passes(log_n, split):
        kw = {}
        if s0 == 0 and pro != PRO_NONE:
            kw.update(pro=pro, ptab=ptab, pk=pk)
        if s1 == log_n and epi != EPI_NONE:
            kw.update(epi=epi, etab=etab, ek=ek)
        y = run(xs if s0 == 0 else [y], twst, s0, s1, **kw)
    return y


def transform_split(kind: str, xs, plan: NttPlan, split=None,
                    plain: bool = False) -> torch.Tensor:
    """The transform `kind` of KINDS over xs ([x], or [a, b, c] for the
    quotient) with its passes forced to `split` (stages a pass, summing to
    log n); None takes default_split on CUDA tensors and one pass of every
    stage for the plain version. ntt, intt, coset_ntt, coset_intt and
    quotient_intt call it with None; tests and measurements force splits."""
    inverse, pro, epi = KINDS[kind]
    t = plan.on(xs[0].device)
    return _run_passes(
        xs, t["twi_st" if inverse else "tw_st"], plan.domain.log_size, split,
        plain or xs[0].device.type == "cpu", pro,
        ptab=t["coset"] if pro == PRO_COSET else None,
        pk=plan.z_inv if pro == PRO_QUOTIENT else None, epi=epi,
        etab=t["coset_inv_n"] if epi == EPI_TABLE else None,
        ek=plan.n_inv if epi == EPI_SCALAR else None)


def ntt(x: torch.Tensor, plan: NttPlan, plain: bool = False) -> torch.Tensor:
    """Forward NTT: coefficients -> evaluations at powers of group_gen."""
    return transform_split("ntt", [x], plan, plain=plain)


def intt(x: torch.Tensor, plan: NttPlan, plain: bool = False) -> torch.Tensor:
    """Inverse NTT: evaluations -> coefficients."""
    return transform_split("intt", [x], plan, plain=plain)


def coset_ntt(x: torch.Tensor, plan: NttPlan,
              plain: bool = False) -> torch.Tensor:
    """Evaluate on the coset g * <omega> (g = 5, matching ark-poly)."""
    return transform_split("coset_ntt", [x], plan, plain=plain)


def coset_intt(x: torch.Tensor, plan: NttPlan,
               plain: bool = False) -> torch.Tensor:
    return transform_split("coset_intt", [x], plan, plain=plain)


def quotient_intt(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                  plan: NttPlan, plain: bool = False) -> torch.Tensor:
    """coset_intt((a b - c) / Z) of coset evaluations a, b, c: the witness
    map's h(x), with the quotient in the first pass."""
    return transform_split("quotient", [a, b, c], plan, plain=plain)


# ---------------------------------------------------------------------------
# the pieces of one transform block-sharded over D ranks
# (parallel/sharded.py runs them, with the exchanges between them)
# ---------------------------------------------------------------------------


def block_source(n: int, D: int, d: int, device) -> torch.Tensor:
    """The inputs of rank d's block. After the DIT's bit reversal, rank d
    holds positions [d m, (d + 1) m), m = n / D; position d m + j holds
    x[brev_n(d m + j)] = x[brev_m(j) D + brev_D(d)]. So the block is the
    m-point DIT input of the stride-D subsequence x[brev_D(d)::D], whose
    indices this returns (the first local pass reverses them itself)."""
    log_d = D.bit_length() - 1
    start = int(format(d, f"0{log_d}b")[::-1], 2) if log_d else 0
    return torch.arange(start, n, D, device=device)


def block_stages(x: torch.Tensor, plan: NttPlan, D: int, d: int,
                 inverse: bool = False) -> torch.Tensor:
    """Stages [0, log m) of the 2^L transform of x ((8, n) words, whole on
    every rank) on rank d of D: the m-point DIT of x[brev_D(d)::D]. Stage s
    multiplies by w_(2^(s+1))^k whatever the transform's size, so the
    passes read the first m columns of the n-point stage-major table (the
    m-point plan's whole table). No 1/n here: it comes with the last
    cross stage (ntt_cross's ek); with D = 1 this is the whole transform
    and the iNTT's last pass scales by 1/n."""
    n = plan.n
    m = n // D
    if D < 1 or D & (D - 1) or m < 2:
        raise ValueError(f"block_stages: {D} ranks do not split a "
                         f"transform of {n}")
    y = x.index_select(1, block_source(n, D, d, x.device))
    twst = plan.on(x.device)["twi_st" if inverse else "tw_st"]
    if D > 1:
        twst = twst[:, :m].contiguous()
    epi = EPI_SCALAR if inverse and D == 1 else EPI_NONE
    return _run_passes([y], twst, m.bit_length() - 1, None,
                       x.device.type == "cpu", epi=epi, ek=plan.n_inv)


def cross_twiddle_column(m: int, k: int, d: int) -> int:
    """The first stage-major column of rank d's twiddles at cross stage k
    (stage s = log m + k): the butterfly at global position p < 2^s of its
    group multiplies by w_(2^(s+1))^p, column 2^s + p, and rank d's
    positions start at p = (d mod 2^k) m."""
    return (m << k) + (d & ((1 << k) - 1)) * m


def ntt_cross_plain(own: torch.Tensor, recv: torch.Tensor,
                    twst: torch.Tensor, col0: int, bit: int,
                    ek=None) -> torch.Tensor:
    """One cross-rank DIT stage on a rank's block: own (8, m) words, recv
    the partner's, twst the (8, n) stage-major table, read at columns
    [col0, col0 + m). bit = 0 (the lower half of the butterfly): own + recv
    tw; bit = 1: recv - own tw. ek, (8,) words: times ek after (the 1/n of
    an iNTT's last stage). Returns a new tensor."""
    m = own.shape[1]
    tw = twst[:, col0:col0 + m]
    mul = functools.partial(FK.mont_mul_plain, spec=L.FR)
    if bit:
        out = L.sub(recv, mul(own, tw), L.FR)
    else:
        out = L.add(own, mul(recv, tw), L.FR)
    if ek is not None:
        out = mul(out, _scalar(ek, out.device))
    return out


def ntt_cross(own: torch.Tensor, recv: torch.Tensor, twst: torch.Tensor,
              col0: int, bit: int, ek=None) -> torch.Tensor:
    """ntt_cross_plain's stage by ntt_cross_kernel on CUDA tensors (the
    plain version on CPU tensors)."""
    if all(t.device.type == "cpu" for t in (own, recv, twst)):
        return ntt_cross_plain(own, recv, twst, col0, bit, ek)
    m, n = own.shape[1], twst.shape[1]
    if not 0 <= col0 <= n - m:
        raise ValueError(f"ntt_cross: columns [{col0}, {col0 + m}) outside "
                         f"the table of {n}")
    dev = cuda.check([own, recv, twst], [(L.NWORDS, m)] * 2 +
                     [(L.NWORDS, n)], "ntt_cross")
    out = torch.empty_like(own)
    cuda.launch("ntt_kernels", "zt_ntt_cross", own.data_ptr(),
                recv.data_ptr(), twst.data_ptr(), n, col0, out.data_ptr(), m,
                int(bit), _host_words(ek), device=dev)
    cuda.count("ntt_cross")
    return out
