"""Field kernels, each beside its plain version.

- ``mont_mul(a, b, spec)``: elementwise Montgomery product of two (8, N)
  word batches (Poseidon's rounds). CUDA kernel
  ``csrc/field_kernels.cu: mont_mul_kernel``; replaces the TPU kernel
  ``pallas_field._mont_mul_call`` (mont_mul_pallas).
- ``butterfly_plain(a, b, tw, spec)``: one radix-2 DIT stage over m
  pairs, (a, b, w) -> (a + w*b, a - w*b), in plain torch: the stage of
  ``ntt.ntt_pass_plain``. On the card the stages run inside the NTT pass
  kernel (``ops/ntt.py``, ``csrc/ntt_kernels.cu``), which replaces
  ``pallas_field.butterfly_call``.
- ``mimc_permute(x, rc, spec)``: the MiMC permutation with key 0,
  x <- (x + c_r)^7 for each row c_r of the (R, 8) round constants, BN254 Fr
  only. CUDA kernel ``mimc_permute_kernel``; replaces
  ``pallas_field.mimc_permute_call``.
- ``inv_fwd``, ``inv_bwd``, ``inv_base`` and their recursion
  ``batch_inv``: Montgomery batch inversion over chains of 16. CUDA kernels
  ``inv_fwd_kernel`` / ``inv_fwd_scan_kernel``, ``inv_bwd_kernel`` /
  ``inv_bwd_scan_kernel`` and ``inv_base_kernel``; replace
  ``pallas_field._inv_fwd_call``, ``_inv_bwd_call`` and ``_fermat_call``
  (``batch_inv_pallas``).

A wrapper takes the plain version only for tensors on the CPU. For CUDA
tensors it launches its kernel or raises: wrong device, type, shape or
contiguity, or a non-zero cudaGetLastError(). The kernels handle BN254 Fq
and Fr and BLS12-381 Fr; other moduli raise.
"""

from __future__ import annotations

import torch

from . import cuda
from . import limbs as L

_FIELD_ID = {L.FQ.modulus: 0, L.FR.modulus: 1, L.BLS_FR.modulus: 2}

# batch inversion: chains of INV_T elements, INV_BLOCK chains to a tile;
# chain c of tile t holds elements INV_TILE * t + INV_BLOCK * i + c
INV_T = 16
INV_BLOCK = 1024
INV_TILE = INV_T * INV_BLOCK


def _field_id(spec: L.FieldSpec) -> int:
    if spec.modulus not in _FIELD_ID:
        raise ValueError("the CUDA field kernels support BN254 Fq and Fr and "
                         "BLS12-381 Fr only")
    return _FIELD_ID[spec.modulus]


def mont_mul_plain(a: torch.Tensor, b: torch.Tensor,
                   spec: L.FieldSpec) -> torch.Tensor:
    return L.pack(L.mul_l(L.unpack(a), L.unpack(b), spec))


def butterfly_plain(a: torch.Tensor, b: torch.Tensor, tw: torch.Tensor,
                    spec: L.FieldSpec):
    al = L.unpack(a)
    bt = L.mul_l(L.unpack(b), L.unpack(tw), spec)
    return L.pack(L.add_l(al, bt, spec)), L.pack(L.sub_l(al, bt, spec))


def mont_mul(a: torch.Tensor, b: torch.Tensor,
             spec: L.FieldSpec) -> torch.Tensor:
    """a * b * 2^-256 mod p, canonical; a, b: (8, N) int32 words."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return mont_mul_plain(a, b, spec)
    n = a.shape[1]
    dev = cuda.check([a, b], [(L.NWORDS, n)] * 2, "mont_mul")
    out = torch.empty_like(a)
    cuda.launch("field_kernels", "zt_mont_mul", _field_id(spec), a.data_ptr(),
                b.data_ptr(), out.data_ptr(), n, device=dev)
    cuda.LAUNCHES["mont_mul"] += 1
    return out


# ---------------------------------------------------------------------------
# MiMC permutation
# ---------------------------------------------------------------------------


def _mimc_field(spec: L.FieldSpec) -> None:
    if spec.modulus != L.FR.modulus:
        raise ValueError("mimc_permute supports BN254 Fr only")


def mimc_permute_plain(x: torch.Tensor, rc: torch.Tensor,
                       spec: L.FieldSpec) -> torch.Tensor:
    _mimc_field(spec)
    s = L.unpack(x)
    for r in range(rc.shape[0]):
        t = L.add_l(s, L.unpack(rc[r].reshape(L.NWORDS, 1)), spec)
        t2 = L.mul_l(t, t, spec)
        t4 = L.mul_l(t2, t2, spec)
        s = L.mul_l(L.mul_l(t4, t2, spec), t, spec)
    return L.pack(s)


def mimc_permute(x: torch.Tensor, rc: torch.Tensor,
                 spec: L.FieldSpec) -> torch.Tensor:
    """(x + c_r)^7 for each round r; x: (8, N) Montgomery words, rc: (R, 8)
    Montgomery words of the round constants."""
    _mimc_field(spec)
    if x.device.type == "cpu" and rc.device.type == "cpu":
        return mimc_permute_plain(x, rc, spec)
    n, rounds = x.shape[1], rc.shape[0]
    dev = cuda.check([x, rc], [(L.NWORDS, n), (rounds, L.NWORDS)],
                     "mimc_permute")
    out = torch.empty_like(x)
    cuda.launch("field_kernels", "zt_mimc_permute", x.data_ptr(),
                rc.data_ptr(), out.data_ptr(), n, rounds, device=dev)
    cuda.LAUNCHES["mimc_permute"] += 1
    return out


# ---------------------------------------------------------------------------
# batch inversion
# ---------------------------------------------------------------------------


def inv_chains(n: int) -> int:
    """Chains (and chain totals) of an n-element level: INV_BLOCK per tile,
    the partial last tile included."""
    if n <= 0 or n % INV_BLOCK:
        raise ValueError(f"batch inversion needs a positive multiple of "
                         f"{INV_BLOCK} elements, got {n}")
    return -(-n // INV_TILE) * INV_BLOCK


def _segments(n: int):
    """(first element, tiles, chain length) of the whole tiles, then of the
    partial last tile."""
    full, rest = divmod(n, INV_TILE)
    segs = [(0, full, INV_T)] if full else []
    if rest:
        segs.append((full * INV_TILE, 1, rest // INV_BLOCK))
    return segs


def _chain_view(words: torch.Tensor, start: int, tiles: int, length: int):
    """(16, tiles, length, INV_BLOCK) limbs of one segment."""
    seg = words[:, start:start + tiles * length * INV_BLOCK]
    return L.unpack(seg).reshape(L.NLIMBS, tiles, length, INV_BLOCK)


def _one_limbs(spec: L.FieldSpec, device) -> torch.Tensor:
    """(16, 1, 1) limbs of one in Montgomery form."""
    return L.unpack(L.to_tensor(spec.one_mont, device)).reshape(L.NLIMBS, 1, 1)


def _zero_as_one(x: torch.Tensor, spec: L.FieldSpec):
    """(x with its zero elements replaced by one, the zero mask) of
    (16, tiles, INV_BLOCK) limbs."""
    zero = (x == 0).all(dim=0)
    return torch.where(zero[None], _one_limbs(spec, x.device), x), zero


def inv_fwd_plain(a: torch.Tensor, spec: L.FieldSpec):
    inv_chains(a.shape[1])
    prefix, totals = [], []
    for start, tiles, length in _segments(a.shape[1]):
        x = _chain_view(a, start, tiles, length)
        acc = _one_limbs(spec, a.device).expand(L.NLIMBS, tiles, INV_BLOCK)
        pre = torch.empty_like(x)
        for i in range(length):
            pre[:, :, i] = acc
            acc = L.mul_l(acc, _zero_as_one(x[:, :, i], spec)[0], spec)
        prefix.append(L.pack(pre).reshape(L.NWORDS, -1))
        totals.append(L.pack(acc).reshape(L.NWORDS, -1))
    return torch.cat(prefix, dim=1), torch.cat(totals, dim=1)


def inv_bwd_plain(a: torch.Tensor, prefix: torch.Tensor, tinv: torch.Tensor,
                  spec: L.FieldSpec) -> torch.Tensor:
    inv_chains(a.shape[1])
    out = []
    for start, tiles, length in _segments(a.shape[1]):
        x = _chain_view(a, start, tiles, length)
        pre = _chain_view(prefix, start, tiles, length)
        t0 = start // INV_TILE * INV_BLOCK
        s = L.unpack(tinv[:, t0:t0 + tiles * INV_BLOCK]).reshape(
            L.NLIMBS, tiles, INV_BLOCK)
        res = torch.empty_like(x)
        for i in reversed(range(length)):
            xi, zero = _zero_as_one(x[:, :, i], spec)
            res[:, :, i] = torch.where(zero[None], 0,
                                       L.mul_l(s, pre[:, :, i], spec))
            s = L.mul_l(s, xi, spec)
        out.append(L.pack(res).reshape(L.NWORDS, -1))
    return torch.cat(out, dim=1)


def inv_base_plain(a: torch.Tensor, spec: L.FieldSpec) -> torch.Tensor:
    """a^(p-2) by left-to-right square-and-multiply: the inverse's plain
    definition (inv(0) = 0)."""
    x = L.unpack(a)
    acc = x
    for bit in bin(spec.modulus - 2)[3:]:
        acc = L.mul_l(acc, acc, spec)
        if bit == "1":
            acc = L.mul_l(acc, x, spec)
    return L.pack(acc)


def inv_fwd(a: torch.Tensor, spec: L.FieldSpec):
    """Exclusive prefix products along each chain, in the elements' places,
    and the chain totals: a (8, n) words, n a multiple of 1,024 ->
    (prefix (8, n), totals (8, inv_chains(n))). A zero element counts as
    one in the products, so the totals are products of the nonzero
    elements. Replaces pallas_field._inv_fwd_call.

    On the card: levels of 8 tiles or more run inv_fwd_kernel, a thread a
    chain, the serial chain fed from a ring of four steps staged in shared
    memory by cp.async; shorter levels run inv_fwd_scan_kernel, a thread
    per element and a prefix-product scan in shared memory (depth
    log2(16)). Bound by bytes at 2^20 elements, by latency below. a must
    be 16-byte aligned, as fresh tensors are."""
    return _inv_fwd(a, spec, 0)


def inv_fwd_mapped(a: torch.Tensor, spec: L.FieldSpec, scan: bool):
    """inv_fwd with its thread mapping forced on the card (scan=False: a
    thread a chain, True: the prefix scan), so that a measurement can time
    both at one n; the inversion calls inv_fwd, which picks by n."""
    return _inv_fwd(a, spec, 2 if scan else 1)


def _inv_fwd(a, spec, mapping: int):
    if a.device.type == "cpu":
        return inv_fwd_plain(a, spec)
    n = a.shape[1]
    chains = inv_chains(n)
    dev = cuda.check([a], [(L.NWORDS, n)], "inv_fwd")
    if a.data_ptr() % 16:
        raise ValueError("inv_fwd: a must be 16-byte aligned")
    prefix = torch.empty_like(a)
    totals = torch.empty((L.NWORDS, chains), dtype=torch.int32, device=dev)
    cuda.launch("field_kernels", "zt_inv_fwd", _field_id(spec), a.data_ptr(),
                prefix.data_ptr(), totals.data_ptr(), n, mapping, device=dev)
    cuda.LAUNCHES["inv_fwd"] += 1
    return prefix, totals


def inv_bwd(a: torch.Tensor, prefix: torch.Tensor, tinv: torch.Tensor,
            spec: L.FieldSpec) -> torch.Tensor:
    """Inverses of a from its prefixes and the inverses of its chain
    totals; replaces pallas_field._inv_bwd_call. Zero where a is zero, a
    zero counting as one in the suffix products (as in inv_fwd).

    On the card: levels of 8 tiles or more run inv_bwd_kernel, two
    threads a chain (the serial suffix chain s <- s * a_i on one, the
    independent s * prefix_i one step behind on the other) with a ring of
    four steps staged in shared memory by cp.async; shorter levels, where
    that leaves most of the card idle, run inv_bwd_scan_kernel, a thread
    per element and a suffix-product scan in shared memory (depth log2(16)
    + 1 products). Bound by the integer multiply rate at 2^20 elements
    (2n Montgomery products), by latency below. a and prefix must be
    16-byte aligned, as fresh tensors are."""
    return _inv_bwd(a, prefix, tinv, spec, 0)


def inv_bwd_mapped(a: torch.Tensor, prefix: torch.Tensor, tinv: torch.Tensor,
                   spec: L.FieldSpec, scan: bool) -> torch.Tensor:
    """inv_bwd with its thread mapping forced on the card (scan=False: two
    threads a chain, True: the suffix scan), so that a measurement can time
    both at one n; the inversion calls inv_bwd, which picks by n."""
    return _inv_bwd(a, prefix, tinv, spec, 2 if scan else 1)


def _inv_bwd(a, prefix, tinv, spec, mapping: int) -> torch.Tensor:
    if all(t.device.type == "cpu" for t in (a, prefix, tinv)):
        return inv_bwd_plain(a, prefix, tinv, spec)
    n = a.shape[1]
    chains = inv_chains(n)
    dev = cuda.check([a, prefix, tinv], [(L.NWORDS, n)] * 2
                     + [(L.NWORDS, chains)], "inv_bwd")
    if (a.data_ptr() | prefix.data_ptr()) % 16:
        raise ValueError("inv_bwd: a and prefix must be 16-byte aligned")
    out = torch.empty_like(a)
    cuda.launch("field_kernels", "zt_inv_bwd", _field_id(spec), a.data_ptr(),
                prefix.data_ptr(), tinv.data_ptr(), out.data_ptr(), n,
                mapping, device=dev)
    cuda.LAUNCHES["inv_bwd"] += 1
    return out


def inv_base(a: torch.Tensor, spec: L.FieldSpec) -> torch.Tensor:
    """The inverse of each element of (8, n) Montgomery words, any n;
    inv(0) = 0. Replaces pallas_field._fermat_call (the recursion's base).

    On the card inv_base_kernel runs the fixed-count safegcd of
    csrc/field.cuh (600 divsteps on signed 30-bit limbs, then one product
    by R^3), one thread per element, one warp a block. The recursion's
    1,024-element base cannot fill the card, so the bound is one thread's
    dependent chain: ~20 x 30 divsteps and their matrix updates instead of
    the ~380 dependent Montgomery products of a^(p-2)."""
    if a.device.type == "cpu":
        return inv_base_plain(a, spec)
    n = a.shape[1]
    dev = cuda.check([a], [(L.NWORDS, n)], "inv_base")
    out = torch.empty_like(a)
    cuda.launch("field_kernels", "zt_inv_base", _field_id(spec),
                a.data_ptr(), out.data_ptr(), n, device=dev)
    cuda.LAUNCHES["inv_base"] += 1
    return out


def batch_inv(a: torch.Tensor, spec: L.FieldSpec,
              plain: bool = False) -> torch.Tensor:
    """Inverses of (8, n) Montgomery words, n a multiple of 1,024: inv_fwd,
    the chain totals inverted recursively down to one block of 1,024, which
    inv_base inverts, then inv_bwd. A zero comes back zero, as inv_base
    gives it: inv_fwd and inv_bwd count it as one, so the chain totals are
    products of nonzero factors. ``plain=True`` runs the plain versions on
    any device (the reference on the card)."""
    fwd, bwd, base = ((inv_fwd_plain, inv_bwd_plain, inv_base_plain) if plain
                      else (inv_fwd, inv_bwd, inv_base))
    if a.shape[1] == INV_BLOCK:
        return base(a, spec)
    prefix, totals = fwd(a, spec)
    return bwd(a, prefix, batch_inv(totals, spec, plain), spec)
