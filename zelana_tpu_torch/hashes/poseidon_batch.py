"""Batched Poseidon on Montgomery words: the port's counterpart of the JAX
package's ``hashes/poseidon_jax.py``.

For bulk commitment and nullifier hashing (the privacy SDK's note stack) and
the L2 circuit's Poseidon folds; bit-equal to the host sponge in
``hashes/poseidon.py``. Every configuration the reference uses: BN254 8/56
and 8/57, BLS12-381 8/57.

State: (width = 3, 8, *B) words, carried through a permutation as one
(8, width, n) tensor. A full round s-boxes all three lanes, a partial round
lane 0 only; the MDS apply is 9 products and 6 adds. Every product is the
``mont_mul`` kernel on CUDA tensors, the lanes of a round side by side in one
call (three for the s-box, one for the 9 MDS products); the adds are torch
ops over all lanes at once. As in the JAX package, the rounds are a loop of
these ops, not a kernel of their own.
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
def _tables(cfg: PoseidonConfig):
    """(ark (rounds, width, 8), mds (width, width, 8)) uint32 Montgomery
    words and the (rounds,) full-round flags."""
    spec = _spec_for(cfg)
    total = cfg.full_rounds + cfg.partial_rounds
    ark = np.stack([L.encode_mont(list(cfg.ark[r]), spec).T
                    for r in range(total)])
    mds = np.stack([L.encode_mont(list(cfg.mds[i]), spec).T
                    for i in range(cfg.width)])
    half = cfg.full_rounds // 2
    is_full = np.array([r < half or r >= half + cfg.partial_rounds
                        for r in range(total)])
    return ark, mds, is_full


@functools.lru_cache(maxsize=None)
def _device_tables(cfg: PoseidonConfig, dev: torch.device):
    """_tables' ark and mds as int32 tensors on `dev` in the state's layout:
    ark (rounds, 8, width, 1), mds (8, width, width, 1) with mds[:, i, j]
    the constant that multiplies lane j into lane i."""
    ark, mds, _ = _tables(cfg)
    return (L.to_tensor(ark.transpose(0, 2, 1)[..., None], dev),
            L.to_tensor(mds.transpose(2, 0, 1)[..., None], dev))


def _permute(state: torch.Tensor, cfg: PoseidonConfig) -> torch.Tensor:
    """One permutation of an (8, width, n) state."""
    spec = _spec_for(cfg)
    is_full = _tables(cfg)[2]
    w, n = cfg.width, state.shape[2]
    ark, mds = _device_tables(cfg, state.device)
    # mont_mul takes (8, N) operands: the MDS constants expanded once
    mds_n = mds.expand(L.NWORDS, w, w, n).contiguous().reshape(L.NWORDS, -1)

    def sbox5(x):  # (8, N) -> x^5
        x2 = FK.mont_mul(x, x, spec)
        return FK.mont_mul(FK.mont_mul(x2, x2, spec), x, spec)

    for r in range(len(is_full)):
        state = L.add(state, ark[r], spec)
        if is_full[r]:
            state = sbox5(state.reshape(L.NWORDS, -1)).reshape(state.shape)
        else:
            state[:, 0] = sbox5(state[:, 0].contiguous())
        # prod[:, i, j] = state[:, j] * mds[:, i, j], then sum over j
        lanes = state.unsqueeze(1).expand(L.NWORDS, w, w, n).contiguous()
        prod = FK.mont_mul(lanes.reshape(L.NWORDS, -1), mds_n, spec).reshape(
            L.NWORDS, w, w, n)
        state = prod[:, :, 0]
        for j in range(1, w):
            state = L.add(state, prod[:, :, j], spec)
    return state


def poseidon_permute_batch(state: torch.Tensor,
                           cfg: PoseidonConfig) -> torch.Tensor:
    """state: (width, 8, *B) -> same, one permutation."""
    flat = state.reshape(cfg.width, L.NWORDS, -1).transpose(0, 1)
    out = _permute(flat.contiguous(), cfg).transpose(0, 1)
    return out.contiguous().reshape(state.shape)


def poseidon_hash_batch(cfg: PoseidonConfig, columns) -> torch.Tensor:
    """absorb(columns); squeeze(1) for a batch. columns: list of (8, *B).

    Matches PoseidonSponge.absorb(list) + squeeze(1) for rate 2 / capacity
    1: elements fill the rate slots two at a time with a permutation between
    chunks, plus the final squeeze permutation; the output is state[1]."""
    spec = _spec_for(cfg)
    shape = columns[0].shape
    cols = [c.reshape(L.NWORDS, -1) for c in columns]
    state = cols[0].new_zeros((L.NWORDS, cfg.width, cols[0].shape[1]))
    idx = 0
    for col in cols:
        if idx == cfg.rate:
            state = _permute(state, cfg)
            idx = 0
        k = cfg.capacity + idx
        state[:, k] = L.add(state[:, k], col, spec)
        idx += 1
    out = _permute(state, cfg)[:, cfg.capacity]
    return out.contiguous().reshape(shape)


def hash_many(cfg: PoseidonConfig, rows, device="cuda") -> list:
    """rows: equal-length tuples of ints -> their hashes, computed on
    `device`."""
    dev = resolve(device)
    spec = _spec_for(cfg)
    cols = [L.to_tensor(L.encode_mont([row[i] for row in rows], spec), dev)
            for i in range(len(rows[0]))]
    return L.decode_mont(L.to_numpy(poseidon_hash_batch(cfg, cols)), spec)
