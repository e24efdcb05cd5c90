"""Batched MiMC-91 over BN254 Fr on (8, *B) Montgomery words.

The port's counterpart of the JAX package's ``hashes/mimc_jax.py``: hashes
many independent inputs per call (account leaves, nullifiers, commitments,
tree levels), bit-equal to the host sponge in ``hashes/mimc.py``. The
permutation is the ``mimc_permute`` kernel on CUDA tensors (all 91 rounds,
state in registers) and its plain version on CPU tensors; the sponge's
field adds are torch ops.
"""

from __future__ import annotations

import functools

import torch

from ..device import resolve
from ..ops import field_kernels as FK
from ..ops import limbs as L
from .mimc import round_constants


@functools.lru_cache(maxsize=None)
def _round_constants(device: torch.device) -> torch.Tensor:
    """(91, 8) int32 Montgomery words of the round constants on `device`."""
    words = L.encode_mont(list(round_constants()), L.FR)  # (8, 91)
    return L.to_tensor(words.T, device)


def mimc_permute_batch(x: torch.Tensor) -> torch.Tensor:
    """MiMC permutation with key 0 on a (8, *B) Montgomery batch."""
    flat = x.reshape(L.NWORDS, -1).contiguous()
    out = FK.mimc_permute(flat, _round_constants(flat.device), L.FR)
    return out.reshape(x.shape)


def mimc_sponge_batch(inputs) -> torch.Tensor:
    """Sponge absorb over the leading axis: inputs (k, 8, *B) -> (8, *B).

    Equal to mimc_sponge_absorb([v_1..v_k], 0) per batch element."""
    state = torch.zeros_like(inputs[0])
    for col in inputs:
        state = mimc_permute_batch(L.add(state, col, L.FR))
    return state


def _constant_like(value: int, like: torch.Tensor) -> torch.Tensor:
    col = L.to_tensor(L.encode_mont([value], L.FR), like.device)
    return col.reshape((L.NWORDS,) + (1,) * (like.dim() - 1)).expand_as(like)


def hash2_batch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched hash_2: leaves of the account and commitment SMTs."""
    return mimc_sponge_batch([_constant_like(2, a), a, b])


def hash_n_batch(columns) -> torch.Tensor:
    """Batched hash_n over a list of (8, *B) columns."""
    return mimc_sponge_batch([_constant_like(len(columns), columns[0]),
                              *columns])


def hash2_many(pairs, device="cuda") -> list:
    """[(a, b)] ints -> [hash_2(a, b)], computed on `device`."""
    dev = resolve(device)
    a, b = (L.to_tensor(L.encode_mont([p[k] for p in pairs], L.FR), dev)
            for k in (0, 1))
    return L.decode_mont(L.to_numpy(hash2_batch(a, b)), L.FR)
