"""The batch prover service on the card (the BatchProver contract).

Mirrors core/src/sequencer/settlement/prover.rs:
- the public inputs and witness of a sealed batch (:506-522, :357-389);
- ``Groth16Prover``: builds the L2BlockCircuit from the batch witness,
  proves it through the port's kernels, serializes to the 256-byte Solana
  format (:252-447);
- the wire format of the deployed verifier (``proof_to_solana_bytes``).

The hash-derived ``MockProver`` and the remote ``NoirProverClient`` never
touch a device, so the port has no copy of them: ``build_prover_from_config``
builds the Groth16 prover or raises, where the JAX package falls back to a
mock and would hide a missing key or card.
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass, field
from typing import List

from ..circuits.l2_block import (
    L2BlockCircuit,
    TransactionWitness,
    WithdrawalWitness,
)
from ..device import resolve
from ..groth16.keys import Proof, ProvingKey
from .transactions import Shielded, Transfer, Withdraw


@dataclass
class BatchPublicInputs:
    pre_state_root: bytes
    post_state_root: bytes
    pre_shielded_root: bytes
    post_shielded_root: bytes
    withdrawal_root: bytes
    batch_hash: bytes
    batch_id: int


@dataclass
class BatchProof:
    public_inputs: BatchPublicInputs
    proof_bytes: bytes
    proving_time_ms: int


@dataclass
class BatchWitness:
    transactions: List[object] = field(default_factory=list)
    initial_accounts: dict = field(default_factory=dict)  # pk bytes -> balance
    shielded_commitments: List[bytes] = field(default_factory=list)


def compute_batch_hash(transactions) -> bytes:
    """Domain-tagged running hash of batch txs (settlement/prover.rs:525-558;
    blake2b-256 stands in for blake3, which has no stdlib implementation)."""
    h = hashlib.blake2b(digest_size=32)
    for tx in transactions:
        if isinstance(tx, Shielded):
            h.update(b"shielded")
            h.update(tx.nullifier)
            h.update(tx.commitment)
        elif isinstance(tx, Transfer):
            h.update(b"transfer")
            h.update(tx.signer_pubkey)
            h.update(tx.to)
            h.update(tx.amount.to_bytes(8, "little"))
            h.update(tx.nonce.to_bytes(8, "little"))
        elif isinstance(tx, Withdraw):
            h.update(b"withdraw")
            h.update(tx.from_)
            h.update(tx.to_l1_address)
            h.update(tx.amount.to_bytes(8, "little"))
    return h.digest()


def proof_to_solana_bytes(proof: Proof) -> bytes:
    """(negated pi_a | pi_b | pi_c), 256 bytes, in the encoding the DEPLOYED
    verifier's alt_bn128 syscalls consume: big-endian coordinates, G2 with
    the imaginary coefficient first (EIP-197 order).

    NOTE(reference bug, fixed here): the reference prover writes
    little-endian, c0-first bytes (settlement/prover.rs:304-334) that the
    big-endian syscalls would misread; this framework emits what the
    on-chain program actually verifies."""
    from ..curves import g1 as G1

    out = bytearray()
    a_neg = G1.neg(proof.a)
    out += int(a_neg[0]).to_bytes(32, "big")
    out += int(a_neg[1]).to_bytes(32, "big")
    (x0, x1), (y0, y1) = proof.b
    out += int(x1).to_bytes(32, "big")
    out += int(x0).to_bytes(32, "big")
    out += int(y1).to_bytes(32, "big")
    out += int(y0).to_bytes(32, "big")
    out += int(proof.c[0]).to_bytes(32, "big")
    out += int(proof.c[1]).to_bytes(32, "big")
    return bytes(out)


def solana_bytes_to_proof(data: bytes) -> Proof:
    """Inverse of proof_to_solana_bytes (un-negates pi_a)."""
    from ..curves import g1 as G1

    def fbe(off):
        return int.from_bytes(data[off : off + 32], "big")

    a = G1.neg((fbe(0), fbe(32)))
    b = ((fbe(96), fbe(64)), (fbe(160), fbe(128)))
    c = (fbe(192), fbe(224))
    return Proof(a=a, b=b, c=c)


def public_input_values(inputs: BatchPublicInputs) -> List[int]:
    """The circuit's seven public-input field VALUES: roots parsed
    little-endian mod r exactly as the circuit allocates them
    (l2_circuit.rs from_le_bytes_mod_order), then batch_id."""
    from ..fields.bn254 import R as FR_MOD
    from ..fields.fp import from_le_bytes_mod_order

    return [
        from_le_bytes_mod_order(inputs.pre_state_root, FR_MOD),
        from_le_bytes_mod_order(inputs.post_state_root, FR_MOD),
        from_le_bytes_mod_order(inputs.pre_shielded_root, FR_MOD),
        from_le_bytes_mod_order(inputs.post_shielded_root, FR_MOD),
        from_le_bytes_mod_order(inputs.withdrawal_root, FR_MOD),
        from_le_bytes_mod_order(inputs.batch_hash, FR_MOD),
        inputs.batch_id,
    ]


def batch_inputs_to_solana_bytes(inputs: BatchPublicInputs) -> List[bytes]:
    """The settler-side wire serialization: each circuit VALUE as a 32-byte
    BIG-ENDIAN array -- the exact bytes the deployed verifier feeds into
    alt_bn128_multiplication (lib.rs:479-494 passes them through raw, so
    they must already be syscall-convention). batch_id lands big-endian in
    the last 8 bytes, matching lib.rs:487-492."""
    return [v.to_bytes(32, "big") for v in public_input_values(inputs)]


class Groth16Prover:
    """Real Groth16 proofs of sealed batches on one device
    (prover.rs:252-447). `device`: "cuda" by default; with no card this
    raises unless the caller asks for "cpu" (the kernels' plain
    versions)."""

    def __init__(self, proving_key: ProvingKey, device="cuda"):
        self.pk = proving_key
        self.device = resolve(device)
        self.vk_hash = hashlib.blake2b(
            proving_key.vk.serialize_compressed(), digest_size=32
        ).digest()

    @classmethod
    def from_files(cls, pk_path: str, device="cuda") -> "Groth16Prover":
        with open(pk_path, "rb") as f:
            return cls(ProvingKey.deserialize_compressed(f.read()), device)

    def build_circuit(self, inputs: BatchPublicInputs,
                      witness: BatchWitness) -> L2BlockCircuit:
        txs = [
            TransactionWitness(t.signer_pubkey, t.to, t.amount)
            for t in witness.transactions
            if isinstance(t, Transfer)
        ]
        wds = [
            WithdrawalWitness(t.to_l1_address, t.amount)
            for t in witness.transactions
            if isinstance(t, Withdraw)
        ]
        return L2BlockCircuit(
            pre_state_root=inputs.pre_state_root,
            post_state_root=inputs.post_state_root,
            pre_shielded_root=inputs.pre_shielded_root,
            post_shielded_root=inputs.post_shielded_root,
            withdrawal_root=inputs.withdrawal_root,
            batch_hash=inputs.batch_hash,
            batch_id=inputs.batch_id,
            transactions=txs,
            initial_accounts=dict(witness.initial_accounts),
            shielded_commitments=list(witness.shielded_commitments),
            withdrawals=wds,
        )

    def prove(self, inputs: BatchPublicInputs,
              witness: BatchWitness) -> BatchProof:
        from ..groth16.prove import prove as groth16_prove

        start = time.time()
        circuit = self.build_circuit(inputs, witness)
        proof = groth16_prove(self.pk, circuit, batch_id=inputs.batch_id,
                              device=self.device)
        proof_bytes = proof_to_solana_bytes(proof)
        return BatchProof(
            inputs, proof_bytes, int((time.time() - start) * 1000)
        )

    def verify(self, proof: BatchProof) -> bool:
        from ..groth16.verify import verify as groth16_verify

        p = solana_bytes_to_proof(proof.proof_bytes)
        return groth16_verify(
            self.pk.vk, p, public_input_values(proof.public_inputs)
        )

    def verification_key_hash(self) -> bytes:
        return self.vk_hash


def build_public_inputs(batch, withdrawal_root: bytes) -> BatchPublicInputs:
    assert batch.post_state_root is not None, "batch not executed"
    return BatchPublicInputs(
        pre_state_root=batch.pre_state_root,
        post_state_root=batch.post_state_root,
        pre_shielded_root=batch.pre_shielded_root,
        post_shielded_root=batch.post_shielded_root,
        withdrawal_root=withdrawal_root,
        batch_hash=compute_batch_hash(batch.transactions),
        batch_id=batch.id,
    )


def build_witness(batch, get_account) -> BatchWitness:
    """Initial balances for every account the batch touches (pre-state)."""
    initial = {}
    for tx in batch.transactions:
        if isinstance(tx, Transfer):
            for pk in (tx.signer_pubkey, tx.to):
                if pk not in initial:
                    initial[pk] = get_account(pk).balance
        elif isinstance(tx, Withdraw):
            if tx.from_ not in initial:
                initial[tx.from_] = get_account(tx.from_).balance
    cms = [tx.commitment for tx in batch.transactions
           if isinstance(tx, Shielded)]
    return BatchWitness(
        transactions=list(batch.transactions), initial_accounts=initial,
        shielded_commitments=cms,
    )


def build_prover_from_config(cfg, device="cuda") -> Groth16Prover:
    """The Groth16 prover that `cfg` (prover_mode "groth16", mock_prover
    off, proving_key a compressed key file) asks for, on `device`
    (pipeline.rs:217-281, its Groth16 branch). Raises for any other prover
    choice, and when the key or the device fails: the port never returns a
    mock."""
    mode = str(getattr(cfg, "prover_mode", None) or "mock").lower()
    if getattr(cfg, "mock_prover", False) or mode != "groth16":
        raise ValueError(
            f"the port proves with Groth16 only: prover_mode {mode!r}, "
            f"mock_prover {getattr(cfg, 'mock_prover', False)!r}")
    if not getattr(cfg, "proving_key", None):
        raise ValueError("prover_mode groth16 needs a proving_key file")
    return Groth16Prover.from_files(cfg.proving_key, device)
