"""Field kernels of the witness map, each beside its plain version.

- ``mont_mul(a, b, spec)``: elementwise Montgomery product of two (8, N)
  word batches. CUDA kernel ``csrc/field_kernels.cu: mont_mul_kernel``;
  replaces the TPU kernel ``pallas_field._mont_mul_call`` (mont_mul_pallas).
- ``butterfly(a, b, tw, spec)``: one radix-2 DIT stage over m pairs,
  (a, b, w) -> (a + w*b, a - w*b). CUDA kernel ``butterfly_kernel``;
  replaces ``pallas_field.butterfly_call``.

A wrapper takes the plain version only for tensors on the CPU. For CUDA
tensors it launches its kernel or raises: wrong device, type, shape or
contiguity, or a non-zero cudaGetLastError(). The kernels handle BN254 Fq
and Fr; other moduli raise on the card.
"""

from __future__ import annotations

import torch

from . import cuda
from . import limbs as L

_FIELD_ID = {L.FQ.modulus: 0, L.FR.modulus: 1}


def _field_id(spec: L.FieldSpec) -> int:
    if spec.modulus not in _FIELD_ID:
        raise ValueError("the CUDA field kernels support BN254 Fq and Fr only")
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
