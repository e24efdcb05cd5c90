"""The chunk circuit's hash on plain ints: MiMC-91 (x^7, key 0,
numeric-arity domains: zelana_lib/poseidon.nr).

Frozen from zelana_tpu_torch/hashes/mimc.py.
"""

from __future__ import annotations

from .bn254 import R as FR

MIMC_CONSTANTS = tuple(((i + 1) ** 3 + (i + 1)) % FR for i in range(91))


def mimc_permute(x: int) -> int:
    for c in MIMC_CONSTANTS:
        t = (x + c) % FR
        t2 = t * t % FR
        x = t2 * t2 % FR * t2 % FR * t % FR
    return x


def mimc_sponge(values) -> int:
    state = 0
    for v in values:
        state = mimc_permute((state + v) % FR)
    return state


def hash_n(*values: int) -> int:
    return mimc_sponge([len(values), *values])


def account_leaf(pk: int, balance: int, nonce: int) -> int:
    return mimc_sponge([4, 1, pk, balance, nonce])


def derive_public_key(spending_key: int) -> int:
    return hash_n(0x504B, spending_key, 0)


def commitment(owner: int, value: int, blinding: int) -> int:
    return hash_n(owner, value, blinding)


def nullifier(spending_key: int, cm: int, position: int) -> int:
    return hash_n(3, spending_key, cm, position)
