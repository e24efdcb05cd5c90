"""L1 settlement: Solana SubmitBatch instruction building + settlers.

Mirrors core/src/sequencer/settlement/settler.rs:

- SubmitBatchHeader layout: prev_batch_idx u64 | new_batch_idx u64 |
  state_root 32B | proof_len u32 | withdrawal_count u32  = 56 bytes
  (bridge submit_batch.rs:19-56)
- instruction = discriminator | header | proof(256B) | public inputs
- MockSettler keeps an in-memory L1 (settler.rs:1115-1152); the real
  settler builds the exact wire bytes (no RPC egress in this environment,
  so submission is pluggable).
- OnchainVerifyingSettler runs the deployed verifier's algorithm
  (onchain_verifier.py) before it accepts; SunspotSettler takes the
  388-byte chunk proofs; BridgeProgramSettler drives the in-process bridge
  program model (bridge_program.py).
"""

from __future__ import annotations

import hashlib
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .prover_service import BatchProof

# BridgeIx (bridge instruction/mod.rs): INIT=0, DEPOSIT=1,
# WITHDRAWATTESTED=2, SubmitBatch=3
SUBMIT_BATCH_DISCRIMINATOR = 3
WITHDRAW_ATTESTED_DISCRIMINATOR = 2
HEADER_SIZE = 56


def build_withdraw_attested_instruction(recipient: bytes, amount: int,
                                        nullifier: bytes) -> bytes:
    """WithdrawAttested instruction data (settler.rs:812, bridge
    instruction/withdraw.rs): recipient 32B + amount u64 LE +
    nullifier 32B. The settler submits one per finalized withdrawal after
    the batch proof lands (batched L1 execution, settler.rs:694)."""
    return (bytes([WITHDRAW_ATTESTED_DISCRIMINATOR]) + recipient
            + struct.pack("<Q", amount) + nullifier)


def build_submit_batch_header(prev_idx: int, new_idx: int, state_root: bytes,
                              proof_len: int, wd_count: int) -> bytes:
    return (
        struct.pack("<QQ", prev_idx, new_idx)
        + state_root
        + struct.pack("<II", proof_len, wd_count)
    )


def build_submit_batch_instruction(proof: BatchProof, prev_idx: int,
                                   withdrawals=()) -> bytes:
    """Full instruction data for the bridge SubmitBatch (settler.rs:159-310;
    parsed by bridge submit_batch.rs:19-56): discriminator | 56B header |
    256B proof | 200B public inputs (6 x 32B + u64 LE batch_id) |
    withdrawal requests (32B recipient + u64 LE amount each).

    The six 32-byte root arrays go on the wire as big-endian VALUE
    serializations (prover_service.batch_inputs_to_solana_bytes): the
    verifier program passes them raw into the big-endian alt_bn128
    syscalls (lib.rs:479-494), so the settler is where the internal
    LE-parsed root bytes become syscall-convention -- the fix for the
    reference prover's LE/BE mismatch (settlement/prover.rs:304-334).
    The header's new_state_root carries the same wire bytes (the bridge
    cross-checks it against the public inputs, submit_batch.rs:252-256)."""
    from .prover_service import batch_inputs_to_solana_bytes

    inputs = proof.public_inputs
    wire = batch_inputs_to_solana_bytes(inputs)
    header = build_submit_batch_header(
        prev_idx, inputs.batch_id, wire[1],
        len(proof.proof_bytes), len(withdrawals),
    )
    data = bytearray([SUBMIT_BATCH_DISCRIMINATOR])
    data += header
    data += proof.proof_bytes
    # public inputs: 6 roots + batch_id u64 LE (bridge BatchPublicInputs)
    for arr in wire[:6]:
        data += arr
    data += struct.pack("<Q", inputs.batch_id)
    for recipient, amount in withdrawals:
        data += recipient + struct.pack("<Q", amount)
    return bytes(data)


@dataclass
class SettlementResult:
    signature: str
    slot: int


# ---------------------------------------------------------------------------
# Noir/sunspot proof path (settler.rs:343-543)
# ---------------------------------------------------------------------------

SUNSPOT_PROOF_SIZE = 388
SUNSPOT_WITNESS_SIZE = 236
SUNSPOT_COMBINED_SIZE = SUNSPOT_PROOF_SIZE + SUNSPOT_WITNESS_SIZE  # 624


@dataclass
class NoirProofData:
    """388-byte proof + 236-byte public witness (NoirProofData,
    settler.rs:894-925)."""

    proof_bytes: bytes
    public_witness: bytes

    @classmethod
    def from_batch_proof(cls, proof: BatchProof) -> "NoirProofData":
        data = proof.proof_bytes
        if len(data) == SUNSPOT_COMBINED_SIZE:
            return cls(data[:SUNSPOT_PROOF_SIZE], data[SUNSPOT_PROOF_SIZE:])
        if len(data) == SUNSPOT_PROOF_SIZE:
            witness = getattr(proof, "public_witness", b"")
            return cls(data, witness)
        raise ValueError(f"not a sunspot proof: {len(data)} bytes")

    def validate(self):
        if len(self.proof_bytes) != SUNSPOT_PROOF_SIZE:
            raise ValueError(
                f"sunspot proof must be {SUNSPOT_PROOF_SIZE} bytes, got "
                f"{len(self.proof_bytes)}")
        if len(self.public_witness) != SUNSPOT_WITNESS_SIZE:
            raise ValueError(
                f"sunspot witness must be {SUNSPOT_WITNESS_SIZE} bytes, got "
                f"{len(self.public_witness)}")


def is_noir_proof(proof: BatchProof) -> bool:
    """Format autodetect (settler.rs:543-546): 388 or 624 bytes."""
    return len(proof.proof_bytes) in (SUNSPOT_PROOF_SIZE,
                                      SUNSPOT_COMBINED_SIZE)


def build_sunspot_submit_batch(noir: NoirProofData, batch_id: int,
                               post_state_root: bytes,
                               prev_batch_id: int) -> bytes:
    """Discriminator-3 SubmitBatch carrying the 388B proof + 236B witness
    (settler.rs:364-399): 1 + 56-byte header + proof + witness."""
    noir.validate()
    data = bytearray([3])
    data += struct.pack("<QQ", prev_batch_id, batch_id)
    data += post_state_root
    data += struct.pack("<II", len(noir.proof_bytes), 0)
    data += noir.proof_bytes
    data += noir.public_witness
    return bytes(data)


def build_sunspot_direct(noir: NoirProofData) -> bytes:
    """verify_sunspot_direct instruction data (settler.rs:470-497): raw
    proof + witness, no header, no accounts (VK embedded in the program)."""
    noir.validate()
    return noir.proof_bytes + noir.public_witness


class MockSettler:
    """In-memory L1 state (settler.rs MockSettler)."""

    def __init__(self):
        self.submitted: List[bytes] = []
        self.batch_index = 0
        self.slot = 1

    def submit(self, proof: BatchProof) -> SettlementResult:
        data = build_submit_batch_instruction(proof, self.batch_index)
        self.submitted.append(data)
        self.batch_index = proof.public_inputs.batch_id
        sig = hashlib.blake2b(data, digest_size=32).hexdigest()
        self.slot += 1
        return SettlementResult(signature=sig, slot=self.slot)


class OnchainVerifyingSettler:
    """Settler that runs the on-chain verifier algorithm locally before
    accepting -- the litesvm-style check (bridge tests use an in-process VM;
    here the alt_bn128 pairing math runs via our golden pairing)."""

    def __init__(self, vk):
        self.vk = vk
        self.inner = MockSettler()

    def submit(self, proof: BatchProof) -> SettlementResult:
        from .onchain_verifier import verify_batch_proof

        if not verify_batch_proof(self.vk, proof):
            raise ValueError("on-chain verification failed")
        return self.inner.submit(proof)


class SunspotSettler:
    """The sunspot settlement leg with format autodetect
    (settler.rs submit_proof_auto, :555-573): 388/624-byte proofs go down
    the direct-verification path against the chunk VK; 256-byte proofs go
    through the Groth16 bridge CPI path (delegated to `groth16_settler`)."""

    def __init__(self, chunk_vk=None, groth16_settler=None):
        self.chunk_vk = chunk_vk  # VerifyingKey of the chunk circuit
        self.groth16 = groth16_settler or MockSettler()
        self.submitted: List[bytes] = []
        self.slot = 1

    def _verify_sunspot(self, noir: NoirProofData) -> bool:
        if self.chunk_vk is None:
            return True  # mock mode: accept shape-valid proofs
        from ..groth16.verify import verify as groth16_verify
        from ..runtime.chunk_prover import parse_public_witness
        from .prover_service import solana_bytes_to_proof

        p = solana_bytes_to_proof(noir.proof_bytes[:256])
        values = parse_public_witness(noir.public_witness)
        return groth16_verify(self.chunk_vk, p, values)

    def submit_sunspot(self, noir: NoirProofData) -> SettlementResult:
        noir.validate()
        if not self._verify_sunspot(noir):
            raise ValueError("sunspot verification failed")
        data = build_sunspot_direct(noir)
        self.submitted.append(data)
        self.slot += 1
        sig = hashlib.blake2b(data, digest_size=32).hexdigest()
        return SettlementResult(signature=sig, slot=self.slot)

    def submit_auto(self, proof: BatchProof) -> SettlementResult:
        if is_noir_proof(proof):
            return self.submit_sunspot(NoirProofData.from_batch_proof(proof))
        return self.groth16.submit(proof)


class BridgeProgramSettler:
    """Settler driving the in-process bridge program model -- the
    litesvm-style REAL settlement leg: SubmitBatch goes through the bridge
    instruction processor (sequence checks, public-input cross-checks, CPI
    into the verifier program) and finalized withdrawals execute as
    batched WithdrawAttested instructions moving actual vault lamports
    (settler.rs:694-860; nullifier = the withdrawal tx hash)."""

    def __init__(self, svm, domain: bytes, sequencer: bytes):
        from .bridge_program import VERIFIER_PROGRAM_ID, derive_config_pda, \
            derive_vk_pda

        self.svm = svm
        self.domain = domain
        self.sequencer = sequencer
        self.config_pda, _ = derive_config_pda(domain)
        self.vk_pda, _ = derive_vk_pda(domain)
        self.verifier = VERIFIER_PROGRAM_ID

    def store_vk(self, vk):
        from .onchain_verifier import vk_to_solana_account

        return self.svm.store_vk(self.domain, vk_to_solana_account(vk))

    def submit(self, proof: BatchProof) -> SettlementResult:
        from .bridge_program import (
            BRIDGE_PROGRAM_ID,
            AccountMeta,
            Instruction,
            decode_config,
        )

        prev = decode_config(
            self.svm.account(self.config_pda).data)["batch_index"]
        data = build_submit_batch_instruction(proof, prev_idx=prev)
        self.svm.process(Instruction(
            program_id=BRIDGE_PROGRAM_ID,
            accounts=[
                AccountMeta(self.sequencer, is_signer=True),
                AccountMeta(self.config_pda, is_writable=True),
                AccountMeta(self.verifier),
                AccountMeta(self.vk_pda),
            ],
            data=data,
        ))
        sig = hashlib.blake2b(data, digest_size=32).hexdigest()
        self.svm.slot = getattr(self.svm, "slot", 0) + 1
        return SettlementResult(signature=sig, slot=self.svm.slot)

    def execute_withdrawals(self, withdrawals) -> List[SettlementResult]:
        """withdrawals: iterable of (recipient32, amount, tx_hash32);
        one WithdrawAttested each (replay-guarded by the nullifier PDA)."""
        from .bridge_program import (
            BRIDGE_PROGRAM_ID,
            AccountMeta,
            Instruction,
            derive_nullifier_pda,
            derive_vault_pda,
        )

        vault_pda, _ = derive_vault_pda(self.domain)
        results = []
        for recipient, amount, tx_hash in withdrawals:
            nf_pda, _ = derive_nullifier_pda(self.domain, tx_hash)
            data = build_withdraw_attested_instruction(
                recipient, amount, tx_hash)
            self.svm.process(Instruction(
                program_id=BRIDGE_PROGRAM_ID,
                accounts=[
                    AccountMeta(self.sequencer, is_signer=True),
                    AccountMeta(self.config_pda),
                    AccountMeta(vault_pda, is_writable=True),
                    AccountMeta(recipient, is_writable=True),
                    AccountMeta(nf_pda, is_writable=True),
                    AccountMeta(b"\x00" * 32),
                ],
                data=data,
            ))
            sig = hashlib.blake2b(data, digest_size=32).hexdigest()
            results.append(SettlementResult(signature=sig, slot=0))
        return results
