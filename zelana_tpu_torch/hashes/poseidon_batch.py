"""Batched Poseidon on Montgomery words: the port's counterpart of the JAX
package's ``hashes/poseidon_jax.py``.

For bulk commitment and nullifier hashing (the privacy SDK's note stack) and
the L2 circuit's Poseidon folds; bit-equal to the host sponge in
``hashes/poseidon.py``. Every configuration the reference uses: BN254 8/56
and 8/57, BLS12-381 8/57 (width 3, rate 2, capacity 1, alpha 5).

A permutation, or a whole absorb and squeeze, is one call of
``field_kernels.poseidon_permute`` / ``poseidon_sponge``: on CUDA tensors
one launch of ``poseidon_kernel``, every round of every permutation in one
thread a state; on CPU tensors their plain versions. The JAX package runs
the rounds as a ``lax.scan`` whose products reach the ``mont_mul`` kernel
on a TPU.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import resolve
from ..ops import field_kernels as FK
from ..ops import limbs as L
from .poseidon import PoseidonConfig


def _spec_for(cfg: PoseidonConfig) -> L.FieldSpec:
    return L.FieldSpec(cfg.modulus)


@functools.lru_cache(maxsize=None)
def _tables(cfg: PoseidonConfig) -> np.ndarray:
    """The kernel's constants, (FK.poseidon_rows(...), 8) uint32 Montgomery
    words: the ARK rows of each round, then the MDS rows."""
    if (cfg.width, cfg.rate, cfg.capacity, cfg.alpha) != (
            FK.POSEIDON_WIDTH, 2, 1, 5):
        raise ValueError("the batched Poseidon takes width 3, rate 2, "
                         "capacity 1 and alpha 5 only")
    spec = _spec_for(cfg)
    total = cfg.full_rounds + cfg.partial_rounds
    rows = [L.encode_mont(list(cfg.ark[r]), spec).T for r in range(total)]
    rows += [L.encode_mont(list(cfg.mds[i]), spec).T
             for i in range(cfg.width)]
    out = np.concatenate(rows)
    assert out.shape[0] == FK.poseidon_rows(cfg.full_rounds,
                                            cfg.partial_rounds)
    return out


@functools.lru_cache(maxsize=None)
def _device_tables(cfg: PoseidonConfig, dev: torch.device) -> torch.Tensor:
    """_tables as an int32 tensor on `dev`, uploaded once."""
    return L.to_tensor(_tables(cfg), dev)


def poseidon_permute_batch(state: torch.Tensor,
                           cfg: PoseidonConfig) -> torch.Tensor:
    """state: (width, 8, *B) -> same, one permutation."""
    flat = state.reshape(cfg.width, L.NWORDS, -1).contiguous()
    out = FK.poseidon_permute(flat, _device_tables(cfg, state.device),
                              cfg.full_rounds, cfg.partial_rounds,
                              _spec_for(cfg))
    return out.reshape(state.shape)


def poseidon_hash_batch(cfg: PoseidonConfig, columns) -> torch.Tensor:
    """absorb(columns); squeeze(1) for a batch. columns: list of (8, *B).

    Matches PoseidonSponge.absorb(list) + squeeze(1) for rate 2 / capacity
    1: elements fill the rate slots two at a time with a permutation between
    chunks, plus the final squeeze permutation; the output is state[1]."""
    shape = columns[0].shape
    cols = [c.reshape(L.NWORDS, -1).contiguous() for c in columns]
    out = FK.poseidon_sponge(cols, _device_tables(cfg, cols[0].device),
                             cfg.full_rounds, cfg.partial_rounds,
                             _spec_for(cfg))
    return out.reshape(shape)


def hash_many(cfg: PoseidonConfig, rows, device="cuda") -> list:
    """rows: equal-length tuples of ints -> their hashes, computed on
    `device`."""
    dev = resolve(device)
    spec = _spec_for(cfg)
    cols = [L.to_tensor(L.encode_mont([row[i] for row in rows], spec), dev)
            for i in range(len(rows[0]))]
    return L.decode_mont(L.to_numpy(poseidon_hash_batch(cfg, cols)), spec)
