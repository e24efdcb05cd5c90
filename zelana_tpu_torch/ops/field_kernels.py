"""Field kernels, each beside its plain version.

- ``mont_mul(a, b, spec)``: elementwise Montgomery product of two (8, N)
  word batches. CUDA kernel ``csrc/field_kernels.cu: mont_mul_kernel``;
  replaces the TPU kernel ``pallas_field._mont_mul_call`` (mont_mul_pallas).
- ``butterfly(a, b, tw, spec)``: one radix-2 DIT stage over m pairs,
  (a, b, w) -> (a + w*b, a - w*b). CUDA kernel ``butterfly_kernel``;
  replaces ``pallas_field.butterfly_call``.
- ``mimc_permute(x, rc, spec)``: the MiMC permutation with key 0,
  x <- (x + c_r)^7 for each row c_r of the (R, 8) round constants, BN254 Fr
  only. CUDA kernel ``mimc_permute_kernel``; replaces
  ``pallas_field.mimc_permute_call``.
- ``inv_fwd``, ``inv_bwd``, ``fermat`` and their recursion ``batch_inv``:
  Montgomery batch inversion over chains of 16. CUDA kernels
  ``inv_fwd_kernel``, ``inv_bwd_kernel``, ``fermat_kernel``; replace
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


def butterfly(a: torch.Tensor, b: torch.Tensor, tw: torch.Tensor,
              spec: L.FieldSpec):
    """(even, odd) = (a + tw*b, a - tw*b) mod p; all (8, m) int32 words."""
    if all(t.device.type == "cpu" for t in (a, b, tw)):
        return butterfly_plain(a, b, tw, spec)
    m = a.shape[1]
    dev = cuda.check([a, b, tw], [(L.NWORDS, m)] * 3, "butterfly")
    even = torch.empty_like(a)
    odd = torch.empty_like(a)
    cuda.launch("field_kernels", "zt_butterfly", _field_id(spec),
                a.data_ptr(), b.data_ptr(), tw.data_ptr(), even.data_ptr(),
                odd.data_ptr(), m, device=dev)
    cuda.LAUNCHES["butterfly"] += 1
    return even, odd


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


def inv_fwd_plain(a: torch.Tensor, spec: L.FieldSpec):
    inv_chains(a.shape[1])
    prefix, totals = [], []
    for start, tiles, length in _segments(a.shape[1]):
        x = _chain_view(a, start, tiles, length)
        acc = L.unpack(L.to_tensor(spec.one_mont, a.device)).reshape(
            L.NLIMBS, 1, 1).expand(L.NLIMBS, tiles, INV_BLOCK)
        pre = torch.empty_like(x)
        for i in range(length):
            pre[:, :, i] = acc
            acc = L.mul_l(acc, x[:, :, i], spec)
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
            res[:, :, i] = L.mul_l(s, pre[:, :, i], spec)
            s = L.mul_l(s, x[:, :, i], spec)
        out.append(L.pack(res).reshape(L.NWORDS, -1))
    return torch.cat(out, dim=1)


def fermat_plain(a: torch.Tensor, spec: L.FieldSpec) -> torch.Tensor:
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
    (prefix (8, n), totals (8, inv_chains(n)))."""
    if a.device.type == "cpu":
        return inv_fwd_plain(a, spec)
    n = a.shape[1]
    chains = inv_chains(n)
    dev = cuda.check([a], [(L.NWORDS, n)], "inv_fwd")
    prefix = torch.empty_like(a)
    totals = torch.empty((L.NWORDS, chains), dtype=torch.int32, device=dev)
    cuda.launch("field_kernels", "zt_inv_fwd", _field_id(spec), a.data_ptr(),
                prefix.data_ptr(), totals.data_ptr(), n, device=dev)
    cuda.LAUNCHES["inv_fwd"] += 1
    return prefix, totals


def inv_bwd(a: torch.Tensor, prefix: torch.Tensor, tinv: torch.Tensor,
            spec: L.FieldSpec) -> torch.Tensor:
    """Inverses of a from its prefixes and the inverses of its chain
    totals."""
    if all(t.device.type == "cpu" for t in (a, prefix, tinv)):
        return inv_bwd_plain(a, prefix, tinv, spec)
    n = a.shape[1]
    chains = inv_chains(n)
    dev = cuda.check([a, prefix, tinv], [(L.NWORDS, n)] * 2
                     + [(L.NWORDS, chains)], "inv_bwd")
    out = torch.empty_like(a)
    cuda.launch("field_kernels", "zt_inv_bwd", _field_id(spec), a.data_ptr(),
                prefix.data_ptr(), tinv.data_ptr(), out.data_ptr(), n,
                device=dev)
    cuda.LAUNCHES["inv_bwd"] += 1
    return out


def fermat(a: torch.Tensor, spec: L.FieldSpec) -> torch.Tensor:
    """a^(p-2) of each element of (8, n) words, any n; inv(0) = 0."""
    if a.device.type == "cpu":
        return fermat_plain(a, spec)
    n = a.shape[1]
    dev = cuda.check([a], [(L.NWORDS, n)], "fermat")
    out = torch.empty_like(a)
    cuda.launch("field_kernels", "zt_fermat", _field_id(spec), a.data_ptr(),
                out.data_ptr(), n, device=dev)
    cuda.LAUNCHES["fermat"] += 1
    return out


def batch_inv(a: torch.Tensor, spec: L.FieldSpec,
              plain: bool = False) -> torch.Tensor:
    """Inverses of (8, n) nonzero Montgomery words, n a multiple of 1,024:
    inv_fwd, the chain totals inverted recursively down to one block of
    1,024, which fermat inverts, then inv_bwd. ``plain=True`` runs the plain
    versions on any device (the reference on the card)."""
    fwd, bwd, base = ((inv_fwd_plain, inv_bwd_plain, fermat_plain) if plain
                      else (inv_fwd, inv_bwd, fermat))
    if a.shape[1] == INV_BLOCK:
        return base(a, spec)
    prefix, totals = fwd(a, spec)
    return bwd(a, prefix, batch_inv(totals, spec, plain), spec)
