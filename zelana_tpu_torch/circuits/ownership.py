"""Client-side ownership circuit (forge/circuits/ownership/src/main.nr).

Proves knowledge of the spending key behind a note without revealing it:

    owner_pk  = hash_3(PK_DOMAIN, sk, 0)             PK   = 0x504b
    commitment == hash_3(owner_pk, value, blinding)
    nullifier  == hash_4(3, sk, commitment, position)
    blinded_proxy == hash_3(DELEGATE_DOMAIN, commitment, position)
                                                      DELE = 0x44454c45

Public inputs (order): commitment, nullifier, blinded_proxy.
All hashes MiMC-91 with numeric-arity domains. The reference proves this
relation with UltraHonk in the browser (~500 ms WASM); here it is the same
relation over our R1CS so it can ride the Groth16 pipeline, and the
sequencer's delegated flow (api handlers /shielded/delegated) accepts it.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..hashes import mimc
from ..r1cs.system import ConstraintSystem
from .batch_mimc import hash3_var, mimc_sponge_var

PK_DOMAIN = 0x504B
DELEGATE_DOMAIN = 0x44454C45
NULLIFIER_DOMAIN = 3


@dataclass
class OwnershipCircuit:
    # private
    spending_key: int = 0
    note_value: int = 0
    note_blinding: int = 0
    note_position: int = 0
    # public
    commitment: int = 0
    nullifier: int = 0
    blinded_proxy: int = 0

    @classmethod
    def from_witness(cls, spending_key: int, value: int, blinding: int,
                     position: int) -> "OwnershipCircuit":
        pk = mimc.derive_public_key(spending_key)
        cm = mimc.compute_commitment(pk, value, blinding)
        nf = mimc.compute_nullifier(spending_key, cm, position)
        bp = mimc.compute_blinded_proxy(cm, position)
        return cls(spending_key, value, blinding, position, cm, nf, bp)

    def generate_constraints(self, cs: ConstraintSystem):
        commitment = cs.new_input(self.commitment)
        nullifier = cs.new_input(self.nullifier)
        blinded_proxy = cs.new_input(self.blinded_proxy)

        sk = cs.new_witness(self.spending_key)
        value = cs.new_witness(self.note_value)
        blinding = cs.new_witness(self.note_blinding)
        position = cs.new_witness(self.note_position)

        owner_pk = hash3_var(cs, cs.constant(PK_DOMAIN), sk, cs.constant(0))
        computed_cm = hash3_var(cs, owner_pk, value, blinding)
        computed_cm.enforce_equal(commitment)

        computed_nf = mimc_sponge_var(
            cs, [cs.constant(4), cs.constant(NULLIFIER_DOMAIN), sk,
                 computed_cm, position]
        )
        computed_nf.enforce_equal(nullifier)

        computed_bp = hash3_var(
            cs, cs.constant(DELEGATE_DOMAIN), computed_cm, position
        )
        computed_bp.enforce_equal(blinded_proxy)
