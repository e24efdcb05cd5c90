"""MiMC-91 sponge over BN254 Fr (golden, Python ints).

The reference uses this hash family everywhere the Noir circuits touch state:
the account SMT (core/src/sequencer/storage/account_tree.rs:46-125), the
client ownership primitives (sdk/ownership-prover/src/mimc.rs), the Noir
library (forge/circuits/zelana_lib/src/poseidon.nr), and withdrawal/batch
accumulators (account_tree.rs:142-185).

Construction:
    round i:   x -> (x + k + c_i)^7,  c_i = (i+1)^3 + (i+1),  91 rounds
    permute:   91 rounds then final +k (k = 0 in the sponge)
    sponge:    state = 0; for each input: state = permute(state + input)
    hash_n:    sponge over [n, x_1..x_n]  (numeric-arity domain separation)

Byte convention is BIG-endian for tree roots (account_tree.rs:188-204) and
little-endian for the client SDK (ownership-prover/src/lib.rs:36-43); both
helpers are provided.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Sequence

from ..fields.bn254 import R as FR

MIMC_ROUNDS = 91

# Client-side domain separators (sdk/ownership-prover/src/mimc.rs:20-33)
DELEGATE_DOMAIN = 0x44454C45  # "DELE"
PK_DOMAIN = 0x504B  # "PK"
NULLIFIER_DOMAIN = 3


@lru_cache(maxsize=1)
def round_constants():
    return tuple(((i + 1) ** 3 + (i + 1)) % FR for i in range(MIMC_ROUNDS))


def mimc_permute(x: int, k: int = 0) -> int:
    state = x % FR
    for c in round_constants():
        t = (state + k + c) % FR
        t2 = t * t % FR
        t4 = t2 * t2 % FR
        state = t4 * t2 % FR * t % FR  # t^7
    return (state + k) % FR


def mimc_sponge_absorb(inputs: Sequence[int], capacity: int = 0) -> int:
    state = capacity % FR
    for inp in inputs:
        state = mimc_permute((state + inp) % FR, 0)
    return state


def hash_n(*values: int) -> int:
    """hash with numeric-arity domain separator: sponge([n, v_1..v_n])."""
    n = len(values)
    return mimc_sponge_absorb([n, *values], 0)


def hash_2(a: int, b: int) -> int:
    return hash_n(a, b)


def hash_3(a: int, b: int, c: int) -> int:
    return hash_n(a, b, c)


def hash_4(a: int, b: int, c: int, d: int) -> int:
    return hash_n(a, b, c, d)


def hash_5(a: int, b: int, c: int, d: int, e: int) -> int:
    return hash_n(a, b, c, d, e)


def hash_6(a: int, b: int, c: int, d: int, e: int, f: int) -> int:
    return hash_n(a, b, c, d, e, f)


# --- Client ownership primitives (sdk/ownership-prover/src/lib.rs:48-108) ---


def derive_public_key(spending_key: int) -> int:
    return hash_3(PK_DOMAIN, spending_key, 0)


def compute_commitment(owner_pk: int, value: int, blinding: int) -> int:
    return hash_3(owner_pk, value, blinding)


def compute_nullifier(spending_key: int, commitment: int, position: int) -> int:
    return hash_4(NULLIFIER_DOMAIN, spending_key, commitment, position)


def compute_blinded_proxy(commitment: int, position: int) -> int:
    return hash_3(DELEGATE_DOMAIN, commitment, position)


# --- Account leaf / batch accumulators (account_tree.rs:107-185) ---


def compute_account_leaf(pubkey: int, balance: int, nonce: int) -> int:
    """mimc_sponge([4, 1, pubkey, balance, nonce]); 1 = account domain."""
    return mimc_sponge_absorb([4, 1, pubkey, balance, nonce], 0)


def compute_withdrawal_root(batch_id: int, withdrawals=(), num_withdrawals=None) -> int:
    """wd_acc = hash_2(5, batch_id); fold hash_2(acc, wd_hash); final hash_2(acc, n).

    ``withdrawals`` is a sequence of (l1_recipient, amount, sender_pk) field
    triples; wd_hash = hash_3(recipient, amount, sender).
    """
    acc = hash_2(5, batch_id)
    for recipient, amount, sender in withdrawals:
        acc = hash_2(acc, hash_3(recipient, amount, sender))
    n = len(withdrawals) if num_withdrawals is None else num_withdrawals
    return hash_2(acc, n)


def compute_batch_hash(batch_id: int, num_transfers: int, num_withdrawals: int,
                       num_shielded: int, items=()) -> int:
    """batch_acc = hash_2(4, batch_id); fold hash_3(acc, a, b); final hash_4."""
    acc = hash_2(4, batch_id)
    for a, b in items:
        acc = hash_3(acc, a, b)
    return hash_4(acc, num_transfers, num_withdrawals, num_shielded)
