"""Field layer of the port (BN254 Fq and Fr, BLS12-381 Fr): packed 32-bit
words on the device, 16-bit limbs in int64 for the plain versions.

Layout. A batch of field elements is an ``(8, N)`` ``torch.int32`` tensor,
words first: word k of element j holds bits [32k, 32k + 32) of its
Montgomery form (R = 2^256), so a warp reading one word row of 32 neighbouring
elements reads 128 contiguous bytes. This is exactly the JAX package's
"packed" form (limb 2k in the low half of word k, limb 2k+1 in the high half);
``words_from_limbs16`` / ``limbs16_from_words`` convert to and from its
``(16, N)`` 16-bit limb form so tests compare like with like.

Plain arithmetic. torch has no add, shift or compare on uint32 on the CPU, so
the plain versions unpack words into ``(16, *B)`` int64 tensors of 16-bit
limbs (``unpack``), where every product and column sum is exact, and pack the
canonical result back (``pack``). They are the CPU path of every kernel
wrapper and the reference each kernel is held against on the card.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..fields.bn254 import P as _P, R as _R
from ..hashes.poseidon import BLS12_381_FR as _BLS_R

NWORDS = 8
NLIMBS = 16
LIMB_BITS = 16
MASK = (1 << LIMB_BITS) - 1
MONT_R = 1 << 256


@dataclass(frozen=True)
class FieldSpec:
    """Per-field constants, generic in the modulus (< 2^255, so that a + b
    of two canonical elements never carries out of 256 bits)."""

    modulus: int

    def __post_init__(self):
        assert self.modulus < 1 << 255

    @functools.cached_property
    def p_limbs(self) -> tuple:
        return tuple((self.modulus >> (LIMB_BITS * i)) & MASK
                     for i in range(NLIMBS))

    @functools.cached_property
    def n0inv(self) -> int:
        """-p^{-1} mod 2^16."""
        return (-pow(self.modulus, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)

    @functools.cached_property
    def one_mont(self) -> np.ndarray:
        """(8,) uint32 words of one in Montgomery form, 2^256 mod p."""
        return to_words([MONT_R % self.modulus])[:, 0]

    def __hash__(self):
        return hash(self.modulus)


FQ = FieldSpec(_P)
FR = FieldSpec(_R)
BLS_FR = FieldSpec(_BLS_R)


# ---------------------------------------------------------------------------
# host <-> words (numpy, uint32)
# ---------------------------------------------------------------------------


def to_words(values) -> np.ndarray:
    """Python ints (< 2^256) -> (8, N) uint32 words. Not Montgomery."""
    buf = b"".join(int(v).to_bytes(32, "little") for v in values)
    return np.frombuffer(buf, "<u4").reshape(-1, NWORDS).T.astype(np.uint32)


def from_words(words) -> list:
    """(8, N) uint32 words -> Python ints."""
    arr = np.asarray(words).astype("<u4").reshape(NWORDS, -1).T
    buf = np.ascontiguousarray(arr).tobytes()
    return [int.from_bytes(buf[32 * j:32 * (j + 1)], "little")
            for j in range(arr.shape[0])]


NATIVE_MIN = 1024  # below this the ctypes call costs more than it saves


def encode_mont(values, spec: FieldSpec) -> np.ndarray:
    """ints -> (8, N) uint32 words of their Montgomery forms. From
    NATIVE_MIN values up the native batch encoder runs (a Python
    `(v * R) % p` per value costs minutes over a production key's 5.7M point
    coordinates); values outside [0, 2^256) take the Python path."""
    if len(values) >= NATIVE_MIN:
        try:
            buf = b"".join(int(v).to_bytes(32, "little") for v in values)
        except OverflowError:  # negative or >= 2^256
            buf = None
        if buf is not None:
            return encode_mont_u64(
                np.frombuffer(buf, "<u8").reshape(len(values), 4), spec)
    return to_words([(int(v) * MONT_R) % spec.modulus for v in values])


def encode_mont_u64(arr: np.ndarray, spec: FieldSpec) -> np.ndarray:
    """(N, 4) uint64 little-endian limbs -> (8, N) uint32 Montgomery words."""
    from ..r1cs import native_synth as NS

    arr = np.ascontiguousarray(arr, dtype=np.uint64)
    if len(arr) < NATIVE_MIN:
        return to_words([(v * MONT_R) % spec.modulus
                         for v in NS.fr_ints(arr)])
    return NS.words32(NS.mont_encode(arr, spec.modulus))


def decode_mont(words, spec: FieldSpec) -> list:
    rinv = pow(MONT_R, -1, spec.modulus)
    return [(v * rinv) % spec.modulus for v in from_words(words)]


def words_from_limbs16(arr) -> np.ndarray:
    """JAX (16, *B) 16-bit limbs -> (8, *B) uint32 words."""
    arr = np.asarray(arr, dtype=np.uint32)
    return (arr[0::2] & MASK) | (arr[1::2] << 16)


def limbs16_from_words(words) -> np.ndarray:
    """(8, *B) uint32 words -> JAX (16, *B) 16-bit limbs."""
    words = np.asarray(words, dtype=np.uint32)
    out = np.empty((2 * words.shape[0],) + words.shape[1:], np.uint32)
    out[0::2] = words & MASK
    out[1::2] = words >> 16
    return out


# ---------------------------------------------------------------------------
# words <-> torch
# ---------------------------------------------------------------------------


def to_tensor(words, device) -> torch.Tensor:
    """uint32 numpy words -> int32 tensor on `device` (same bits)."""
    arr = np.ascontiguousarray(words, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(arr).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 tensor -> uint32 numpy words (same bits)."""
    return t.detach().cpu().contiguous().numpy().view(np.uint32)


def broadcast(words_1d, n: int, device) -> torch.Tensor:
    """One element's (8,) words -> a contiguous (8, n) batch."""
    col = to_tensor(np.asarray(words_1d, np.uint32).reshape(NWORDS, 1), device)
    return col.expand(NWORDS, n).contiguous()


# ---------------------------------------------------------------------------
# plain arithmetic: (16, *B) int64 tensors of canonical 16-bit limbs
# ---------------------------------------------------------------------------


def unpack(words: torch.Tensor) -> torch.Tensor:
    """(8k, *B) int32 words -> (16k, *B) int64 limbs."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    limbs = torch.stack([w & MASK, w >> LIMB_BITS], dim=1)
    return limbs.reshape(2 * words.shape[0], *words.shape[1:])


def pack(limbs: torch.Tensor) -> torch.Tensor:
    """(16k, *B) int64 limbs -> (8k, *B) int32 words."""
    v = limbs[0::2] | (limbs[1::2] << LIMB_BITS)
    v = v - ((v >> 31) << 32)  # into int32 range: the same 32 bits
    return v.to(torch.int32)


@functools.lru_cache(maxsize=None)
def _p_col(modulus: int, device: torch.device, ndim: int) -> torch.Tensor:
    p = FieldSpec(modulus).p_limbs
    return torch.tensor(p, dtype=torch.int64, device=device).reshape(
        (NLIMBS,) + (1,) * (ndim - 1))


def _carry_sweep(cols: torch.Tensor):
    """Propagate carries so every limb is < 2^16; returns (limbs, carry)."""
    out = torch.empty_like(cols)
    carry = torch.zeros_like(cols[0])
    for i in range(cols.shape[0]):
        v = cols[i] + carry
        out[i] = v & MASK
        carry = v >> LIMB_BITS
    return out, carry


def _sub_borrow(a: torch.Tensor, b: torch.Tensor):
    """a - b over 16 limbs; returns (difference mod 2^256, borrow in {0,1})."""
    out = torch.empty_like(a)
    borrow = torch.zeros_like(a[0])
    for i in range(NLIMBS):
        v = a[i] - b[i] - borrow
        out[i] = v & MASK
        borrow = -(v >> LIMB_BITS)  # v in [-2^16 - 1, 2^16): shift is 0 or -1
    return out, borrow


def add_l(a: torch.Tensor, b: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    s, _ = _carry_sweep(a + b)
    d, borrow = _sub_borrow(s, _p_col(spec.modulus, a.device, a.dim()))
    return torch.where(borrow.bool(), s, d)


def sub_l(a: torch.Tensor, b: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    d, borrow = _sub_borrow(a, b)
    c, _ = _carry_sweep(d + _p_col(spec.modulus, a.device, a.dim()))
    return torch.where(borrow.bool(), c, d)


def mul_l(a: torch.Tensor, b: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """Montgomery product a * b * 2^-256 mod p, canonical (< p).

    Schoolbook columns (each < 2^36), then the limb-serial Montgomery
    reduction with the column carries pushed as it goes; every value stays
    below 2^38, exact in int64."""
    p = _p_col(spec.modulus, a.device, a.dim())
    cols = torch.zeros((2 * NLIMBS,) + a.shape[1:], dtype=torch.int64,
                       device=a.device)
    for i in range(NLIMBS):
        cols[i:i + NLIMBS] += a[i] * b
    for i in range(NLIMBS):
        m = ((cols[i] & MASK) * spec.n0inv) & MASK
        cols[i:i + NLIMBS] += m * p
        cols[i + 1] += cols[i] >> LIMB_BITS
    # t / 2^256 < 2p < 2^256: the sweep's carry out is 0
    res, _ = _carry_sweep(cols[NLIMBS:])
    d, borrow = _sub_borrow(res, p)
    return torch.where(borrow.bool(), res, d)


# word-level plain conveniences: (8, *B) int32 in, (8, *B) int32 out


def add(a: torch.Tensor, b: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    return pack(add_l(unpack(a), unpack(b), spec))


def sub(a: torch.Tensor, b: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    return pack(sub_l(unpack(a), unpack(b), spec))


def is_zero(a: torch.Tensor) -> torch.Tensor:
    """(8, *B) words -> (*B) bool, True where the element is zero."""
    return (a == 0).all(dim=0)


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """mask over the batch dims; a where True, else b."""
    return torch.where(mask[None], a, b)


# ---------------------------------------------------------------------------
# inversion
# ---------------------------------------------------------------------------


def mont_inv(a: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """The inverse of each element of (8, N) Montgomery words; inv(0) = 0.
    On the card this is the inv_base kernel (fixed-count safegcd)."""
    from . import field_kernels as FK

    return FK.inv_base(a, spec)


def mont_batch_inv_nested(a: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """Inverses of (8, N) Montgomery words, any N >= 1; zeros pass through
    as zero.

    Montgomery's trick over chains of 16 (``field_kernels.batch_inv``): the
    zeros are swapped for one, N is padded with one to a multiple of 1,024,
    and the kernels run on CUDA tensors, their plain versions on CPU
    tensors. The JAX package's
    ``mont_batch_inv`` and ``mont_batch_inv_logdepth`` compute the same
    function by other algorithms; here both names are this function."""
    from . import field_kernels as FK

    n = a.shape[1]
    zero = is_zero(a)
    one = to_tensor(spec.one_mont.reshape(NWORDS, 1), a.device)
    safe = select(zero, one, a)
    pad = -n % FK.INV_BLOCK
    if pad:
        safe = torch.cat([safe, one.expand(NWORDS, pad)], dim=1)
    out = FK.batch_inv(safe, spec)[:, :n]
    return select(zero, torch.zeros_like(out), out)


mont_batch_inv = mont_batch_inv_nested
mont_batch_inv_logdepth = mont_batch_inv_nested
