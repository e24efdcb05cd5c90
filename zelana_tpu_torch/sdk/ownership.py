"""Client-side ownership-proof primitives (mirror of sdk/ownership-prover).

The exact MiMC hash chain the delegated shielded flow relies on
(sdk/ownership-prover/src/lib.rs:48-108, mimc.rs:20-33):

    pk  = hash_3(PK_DOMAIN, sk, 0)           PK_DOMAIN = 0x504b ("PK")
    cm  = hash_3(pk, value, blinding)
    nf  = hash_4(3, sk, cm, position)
    bp  = hash_3(DELEGATE_DOMAIN, cm, position)   0x44454c45 ("DELE")

Byte convention is 32-byte little-endian (lib.rs:36-43).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..fields.bn254 import R as FR
from ..hashes import mimc


def _fle(b: bytes) -> int:
    return int.from_bytes(b, "little") % FR


def _to32(v: int) -> bytes:
    return int(v).to_bytes(32, "little")


def derive_public_key(spending_key: int) -> int:
    return mimc.derive_public_key(spending_key)


def derive_public_key_bytes(spending_key: bytes) -> bytes:
    return _to32(mimc.derive_public_key(_fle(spending_key)))


def compute_commitment(owner_pk: int, value: int, blinding: int) -> int:
    return mimc.compute_commitment(owner_pk, value, blinding)


def compute_commitment_bytes(owner_pk: bytes, value: int,
                             blinding: bytes) -> bytes:
    return _to32(mimc.compute_commitment(_fle(owner_pk), value, _fle(blinding)))


def compute_nullifier(spending_key: int, commitment: int, position: int) -> int:
    return mimc.compute_nullifier(spending_key, commitment, position)


def compute_nullifier_bytes(spending_key: bytes, commitment: bytes,
                            position: int) -> bytes:
    return _to32(mimc.compute_nullifier(_fle(spending_key), _fle(commitment),
                                        position))


def compute_blinded_proxy(commitment: int, position: int) -> int:
    return mimc.compute_blinded_proxy(commitment, position)


def compute_blinded_proxy_bytes(commitment: bytes, position: int) -> bytes:
    return _to32(mimc.compute_blinded_proxy(_fle(commitment), position))


@dataclass
class OwnershipWitness:
    """Everything needed for an ownership proof (lib.rs:112-150)."""

    spending_key: int
    note_value: int
    note_blinding: int
    note_position: int
    commitment: int = 0
    nullifier: int = 0
    blinded_proxy: int = 0

    @classmethod
    def generate(cls, spending_key: int, value: int, blinding: int,
                 position: int) -> "OwnershipWitness":
        pk = derive_public_key(spending_key)
        cm = compute_commitment(pk, value, blinding)
        nf = compute_nullifier(spending_key, cm, position)
        bp = compute_blinded_proxy(cm, position)
        return cls(spending_key, value, blinding, position, cm, nf, bp)

    def check(self) -> bool:
        pk = derive_public_key(self.spending_key)
        if compute_commitment(pk, self.note_value, self.note_blinding) != self.commitment:
            return False
        if compute_nullifier(self.spending_key, self.commitment,
                             self.note_position) != self.nullifier:
            return False
        return compute_blinded_proxy(self.commitment,
                                     self.note_position) == self.blinded_proxy
