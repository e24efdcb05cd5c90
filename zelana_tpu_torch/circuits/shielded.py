"""Shielded transfer circuit: 2-in/2-out Zcash-style spend.

Mirrors prover/src/circuit/shielded.rs:

Public inputs (order): merkle_root, nullifiers[], commitments[], fee.
Per input note: commitment recompute Poseidon(value, randomness, owner_pk),
32-deep Merkle inclusion with in-circuit direction bits
(CondSelectGadget), nullifier PRF Poseidon(0x4e554c4c, sk, cm, position),
key derivation Poseidon("ZelanaPK", sk) == owner_pk. Balance:
sum(inputs) == sum(outputs) + fee.

Config note: the reference builds its Poseidon config with prime_bits=255
over BN254 Fr (shielded.rs:365-368), which trips the arkworks
MODULUS_BIT_SIZE assertion at runtime -- a latent reference bug. We pin the
working variant: 254-bit Grain derivation with the same 8 full / 57 partial
rounds (hashes.poseidon.bn254_config_57).
"""

from __future__ import annotations

from dataclasses import dataclass, field as dfield
from typing import List

from ..fields.bn254 import R as FR
from ..fields.fp import from_le_bytes_mod_order
from ..hashes.poseidon import bn254_config_57, poseidon_hash
from ..r1cs.sponge_gadget import PoseidonSpongeVar
from ..r1cs.system import ConstraintSystem, FpVar

MAX_INPUTS = 2
MAX_OUTPUTS = 2
TREE_DEPTH = 32

NULL_DOMAIN = 0x4E554C4C  # "NULL"
PK_DOMAIN_BYTES = b"ZelanaPK" + b"\x00" * 24


def _fle(b: bytes) -> int:
    return from_le_bytes_mod_order(b, FR)


@dataclass
class InputNoteWitness:
    value: int
    randomness: bytes
    owner_pk: bytes
    position: int
    spending_key: bytes
    merkle_path: List[bytes]  # TREE_DEPTH siblings, 32B LE
    path_bits: List[bool]  # True = current node is right child


@dataclass
class OutputNoteWitness:
    value: int
    randomness: bytes
    recipient_pk: bytes


@dataclass
class ShieldedTransferCircuit:
    merkle_root: bytes = b"\x00" * 32
    nullifiers: List[bytes] = dfield(default_factory=list)
    commitments: List[bytes] = dfield(default_factory=list)
    fee: int = 0
    inputs: List[InputNoteWitness] = dfield(default_factory=list)
    outputs: List[OutputNoteWitness] = dfield(default_factory=list)

    def generate_constraints(self, cs: ConstraintSystem):
        cfg = bn254_config_57()

        def P(values: List[FpVar]) -> FpVar:
            sponge = PoseidonSpongeVar(cs, cfg)
            sponge.absorb(values)
            return sponge.squeeze(1)[0]

        root = cs.new_input(_fle(self.merkle_root))
        nullifier_vars = [cs.new_input(_fle(nf)) for nf in self.nullifiers]
        commitment_vars = [cs.new_input(_fle(cm)) for cm in self.commitments]
        fee = cs.new_input(self.fee)

        pk_domain = cs.constant(_fle(PK_DOMAIN_BYTES))
        null_domain = cs.constant(NULL_DOMAIN)

        total_in = cs.constant(0)
        for i, note in enumerate(self.inputs):
            value = cs.new_witness(note.value)
            randomness = cs.new_witness(_fle(note.randomness))
            owner_pk = cs.new_witness(_fle(note.owner_pk))
            position = cs.new_witness(note.position)
            spending_key = cs.new_witness(_fle(note.spending_key))

            cm = P([value, randomness, owner_pk])

            # Merkle inclusion with in-circuit direction bits
            current = cm
            for sib_bytes, is_right in zip(note.merkle_path, note.path_bits):
                sibling = cs.new_witness(_fle(sib_bytes))
                bit = cs.new_witness(1 if is_right else 0)
                cs.enforce(bit, bit - cs.constant(1), cs.constant(0))
                # left = bit ? sibling : current ; right = bit ? current : sibling
                left = bit * (sibling - current) + current
                right = bit * (current - sibling) + sibling
                current = P([left, right])
            current.enforce_equal(root)

            nf = P([null_domain, spending_key, cm, position])
            nf.enforce_equal(nullifier_vars[i])

            derived_pk = P([pk_domain, spending_key])
            derived_pk.enforce_equal(owner_pk)

            total_in = total_in + value

        total_out = cs.constant(0)
        for i, note in enumerate(self.outputs):
            value = cs.new_witness(note.value)
            randomness = cs.new_witness(_fle(note.randomness))
            recipient_pk = cs.new_witness(_fle(note.recipient_pk))
            cm = P([value, randomness, recipient_pk])
            cm.enforce_equal(commitment_vars[i])
            total_out = total_out + value

        total_in.enforce_equal(total_out + fee)


# --------------------------------------------------------------------------
# native (off-circuit) helpers for building witnesses
# --------------------------------------------------------------------------


def note_commitment(value: int, randomness: bytes, owner_pk: bytes) -> int:
    return poseidon_hash(bn254_config_57(), [value, _fle(randomness), _fle(owner_pk)])


def note_nullifier(spending_key: bytes, commitment: int, position: int) -> int:
    return poseidon_hash(
        bn254_config_57(), [NULL_DOMAIN, _fle(spending_key), commitment, position]
    )


def derive_owner_pk(spending_key: bytes) -> int:
    return poseidon_hash(
        bn254_config_57(), [_fle(PK_DOMAIN_BYTES), _fle(spending_key)]
    )


class NoteTree:
    """Append-only depth-32 tree over the circuit's Poseidon (BN254 8/57)."""

    def __init__(self):
        self.cfg = bn254_config_57()
        self.nodes = {}
        self.next_index = 0
        self._empty = [0]
        for _ in range(TREE_DEPTH):
            e = self._empty[-1]
            self._empty.append(poseidon_hash(self.cfg, [e, e]))

    def root(self) -> int:
        return self.nodes.get((TREE_DEPTH, 0), self._empty[TREE_DEPTH])

    def insert(self, commitment: int) -> int:
        pos = self.next_index
        self.next_index += 1
        idx = pos
        cur = commitment
        self.nodes[(0, pos)] = cur
        for level in range(TREE_DEPTH):
            is_right = idx & 1 == 1
            sib = self.nodes.get(
                (level, idx - 1 if is_right else idx + 1), self._empty[level]
            )
            cur = (
                poseidon_hash(self.cfg, [sib, cur])
                if is_right
                else poseidon_hash(self.cfg, [cur, sib])
            )
            idx //= 2
            self.nodes[(level + 1, idx)] = cur
        return pos

    def path(self, position: int):
        sibs, bits = [], []
        idx = position
        for level in range(TREE_DEPTH):
            is_right = idx & 1 == 1
            bits.append(is_right)
            sib = self.nodes.get(
                (level, idx - 1 if is_right else idx + 1), self._empty[level]
            )
            sibs.append(int(sib).to_bytes(32, "little"))
            idx //= 2
        return sibs, bits
