"""In-process model of the on-chain bridge program (litesvm-equivalent).

Re-implements onchain-programs/bridge (pinocchio, no Anchor) as a tiny
account-model VM plus the instruction processors, the way the reference's
bridge tests host the real program in litesvm
(bridge/tests/{init,deposit,withdraw,submit_batch,zk_verification}.rs):

- Instructions (instruction/mod.rs BridgeIx): INIT=0, DEPOSIT=1,
  WITHDRAWATTESTED=2, SubmitBatch=3.
- PDAs (helpers/utils.rs:108-142): config = ["config", domain],
  vault = ["vault", domain], receipt = ["receipt", domain, depositor,
  nonce_le], nullifier = ["nullifier", domain, nullifier].
- State structs (state/*.rs): Config {sequencer_authority, domain,
  state_root, batch_index, bump, is_initialized}, Vault {domain, bump},
  DepositReceipt {depositor, domain, amount, nonce, ts, bump},
  UsedNullifier {domain, nullifier, recipient, amount, used, bump}.
- SubmitBatch (instruction/submit_batch.rs): header + 256B proof + 200B
  public inputs (6 x 32B roots + u64 LE batch_id) + withdrawal requests;
  sequence checks prev==config.batch_index, new==+1; post_state_root and
  batch_id cross-checks; CPI into the verifier program
  (discriminator sha256("global:verify_batch_proof")[..8] + proof +
  inputs, :141-163) with [sequencer, vk_account]; recipients must match
  the withdrawal list; config.state_root/batch_index commit only after
  verification.
- Deposit logs `ZE_DEPOSIT:<depositor>:<amount>:<nonce>` (deposit.rs:118),
  the exact line the sequencer's deposit indexer parses (bridge/ingest.rs).

PDA addresses are modeled as sha256(seeds || program_id ||
"ProgramDerivedAddress") with bump 255 (the ed25519 off-curve search is
irrelevant to program logic)."""

from __future__ import annotations

import hashlib
import struct
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

BRIDGE_PROGRAM_ID = hashlib.sha256(b"zelana-bridge-program").digest()
VERIFIER_PROGRAM_ID = hashlib.sha256(b"zelana-verifier-program").digest()
SYSTEM_PROGRAM_ID = b"\x00" * 32

VERIFY_BATCH_PROOF_DISCRIMINATOR = bytes(
    [0xCA, 0xCE, 0xF3, 0x17, 0x28, 0x3E, 0x42, 0x37]
)

HEADER_LEN = 56
PROOF_LEN = 256
PUBLIC_INPUTS_LEN = 200  # 6 * 32 + u64 batch_id
WITHDRAWAL_LEN = 40  # recipient 32 + amount u64


class ProgramError(Exception):
    pass


def find_program_address(seeds: List[bytes], program_id: bytes) -> Tuple[bytes, int]:
    bump = 255
    h = hashlib.sha256()
    for s in seeds:
        h.update(s)
    h.update(bytes([bump]))
    h.update(program_id)
    h.update(b"ProgramDerivedAddress")
    return h.digest(), bump


def derive_config_pda(domain: bytes) -> Tuple[bytes, int]:
    return find_program_address([b"config", domain], BRIDGE_PROGRAM_ID)


def derive_vault_pda(domain: bytes) -> Tuple[bytes, int]:
    return find_program_address([b"vault", domain], BRIDGE_PROGRAM_ID)


def derive_deposit_receipt_pda(domain: bytes, depositor: bytes,
                               nonce: int) -> Tuple[bytes, int]:
    return find_program_address(
        [b"receipt", domain, depositor, struct.pack("<Q", nonce)],
        BRIDGE_PROGRAM_ID,
    )


def derive_nullifier_pda(domain: bytes, nullifier: bytes) -> Tuple[bytes, int]:
    return find_program_address(
        [b"nullifier", domain, nullifier], BRIDGE_PROGRAM_ID
    )


def derive_vk_pda(domain: bytes) -> Tuple[bytes, int]:
    """Verifier program's chunked-VK account: PDA ["batch_vk", domain]
    (verifier lib.rs:83-110)."""
    return find_program_address([b"batch_vk", domain], VERIFIER_PROGRAM_ID)


@dataclass
class Account:
    lamports: int = 0
    data: bytes = b""
    owner: bytes = SYSTEM_PROGRAM_ID


@dataclass
class AccountMeta:
    pubkey: bytes
    is_signer: bool = False
    is_writable: bool = False


@dataclass
class Instruction:
    program_id: bytes
    accounts: List[AccountMeta]
    data: bytes


# ---------------------------------------------------------------------------
# account state codecs (state/*.rs #[repr(C)] layouts)
# ---------------------------------------------------------------------------


def encode_config(sequencer_authority: bytes, domain: bytes,
                  state_root: bytes, batch_index: int, bump: int,
                  initialized: bool) -> bytes:
    return (sequencer_authority + domain + state_root
            + struct.pack("<Q", batch_index)
            + bytes([bump, 1 if initialized else 0]) + b"\x00" * 6)


def decode_config(data: bytes) -> dict:
    if len(data) < 112:
        raise ProgramError("config account too small")
    return {
        "sequencer_authority": data[0:32],
        "domain": data[32:64],
        "state_root": data[64:96],
        "batch_index": struct.unpack("<Q", data[96:104])[0],
        "bump": data[104],
        "is_initialized": data[105] == 1,
    }


def encode_receipt(depositor: bytes, domain: bytes, amount: int, nonce: int,
                   ts: int, bump: int) -> bytes:
    return (depositor + domain + struct.pack("<QQq", amount, nonce, ts)
            + bytes([bump, 1]) + b"\x00" * 6)


def encode_nullifier(domain: bytes, nullifier: bytes, recipient: bytes,
                     amount: int, bump: int) -> bytes:
    return (domain + nullifier + recipient + struct.pack("<Q", amount)
            + bytes([1, bump]) + b"\x00" * 6)


# ---------------------------------------------------------------------------
# the SVM
# ---------------------------------------------------------------------------


class BridgeSVM:
    """Minimal account-model VM hosting the bridge + verifier programs."""

    def __init__(self):
        self.accounts: Dict[bytes, Account] = {}
        self.logs: List[str] = []
        self.clock = int(time.time())

    # -- account helpers -----------------------------------------------------

    def account(self, pubkey: bytes) -> Account:
        if pubkey not in self.accounts:
            self.accounts[pubkey] = Account()
        return self.accounts[pubkey]

    def airdrop(self, pubkey: bytes, lamports: int):
        self.account(pubkey).lamports += lamports

    def balance(self, pubkey: bytes) -> int:
        return self.account(pubkey).lamports

    def log(self, msg: str):
        self.logs.append(msg)

    # -- verifier program ------------------------------------------------------

    def store_vk(self, domain: bytes, vk_solana: dict):
        """Model of the chunked VK upload (init_batch_vk/append_ic_points/
        finalize, verifier lib.rs:379-433): account data = alpha(64) |
        beta(128) | gamma(128) | delta(128) | ic_len u32 | ic points."""
        vk_pda, _ = derive_vk_pda(domain)
        data = (vk_solana["alpha_g1"] + vk_solana["beta_g2"]
                + vk_solana["gamma_g2"] + vk_solana["delta_g2"]
                + struct.pack("<I", len(vk_solana["ic"]))
                + b"".join(vk_solana["ic"]))
        acc = self.account(vk_pda)
        acc.data = data
        acc.owner = VERIFIER_PROGRAM_ID
        return vk_pda

    def _load_vk(self, vk_pda: bytes) -> dict:
        data = self.account(vk_pda).data
        if len(data) < 448 + 4:
            raise ProgramError("vk account not initialized")
        ic_len = struct.unpack("<I", data[448:452])[0]
        ic = [data[452 + 64 * i: 452 + 64 * (i + 1)] for i in range(ic_len)]
        return {
            "alpha_g1": data[0:64],
            "beta_g2": data[64:192],
            "gamma_g2": data[192:320],
            "delta_g2": data[320:448],
            "ic": ic,
        }

    def _process_verifier(self, ix: Instruction):
        """verify_batch_proof entry (verifier lib.rs:438-475): accounts
        [caller(signer), vk_account]; data = discriminator(8) + proof(256)
        + public inputs(200)."""
        from .onchain_verifier import verify_groth16_with_alt_bn254

        if ix.data[:8] != VERIFY_BATCH_PROOF_DISCRIMINATOR:
            raise ProgramError("unknown verifier instruction")
        body = ix.data[8:]
        if len(body) < PROOF_LEN + PUBLIC_INPUTS_LEN:
            raise ProgramError("verifier instruction too short")
        proof = body[:PROOF_LEN]
        pi = body[PROOF_LEN:PROOF_LEN + PUBLIC_INPUTS_LEN]
        batch_id = struct.unpack("<Q", pi[192:200])[0]
        input_bytes = [pi[32 * i: 32 * (i + 1)] for i in range(6)]
        input_bytes.append(batch_id.to_bytes(32, "big"))  # lib.rs:487-492
        vk = self._load_vk(ix.accounts[1].pubkey)
        ok = verify_groth16_with_alt_bn254(
            proof[0:64], proof[64:192], proof[192:256], input_bytes, vk
        )
        if not ok:
            raise ProgramError("proof verification failed")
        self.log(f"Batch proof verified successfully for batch_id: {batch_id}")

    # -- bridge program --------------------------------------------------------

    def process(self, ix: Instruction):
        """Process one transaction (one instruction + implied CPIs)."""
        if ix.program_id == VERIFIER_PROGRAM_ID:
            return self._process_verifier(ix)
        if ix.program_id != BRIDGE_PROGRAM_ID:
            raise ProgramError("unknown program")
        if not ix.data:
            raise ProgramError("empty instruction data")
        disc = ix.data[0]
        body = ix.data[1:]
        if disc == 0:
            return self._init(ix, body)
        if disc == 1:
            return self._deposit(ix, body)
        if disc == 2:
            return self._withdraw_attested(ix, body)
        if disc == 3:
            return self._submit_batch(ix, body)
        raise ProgramError("invalid instruction")

    def _check_signer(self, meta: AccountMeta):
        if not meta.is_signer:
            raise ProgramError("missing required signature")

    def _init(self, ix: Instruction, body: bytes):
        """instruction/init.rs."""
        if len(ix.accounts) < 4:
            raise ProgramError("not enough account keys")
        payer, config_m, vault_m = ix.accounts[0], ix.accounts[1], ix.accounts[2]
        self._check_signer(payer)
        if len(body) < 64:
            raise ProgramError("bad init params")
        sequencer_authority, domain = body[0:32], body[32:64]
        if domain == b"\x00" * 32 or sequencer_authority == b"\x00" * 32:
            raise ProgramError("invalid argument")
        config_pda, config_bump = derive_config_pda(domain)
        vault_pda, vault_bump = derive_vault_pda(domain)
        if config_m.pubkey != config_pda or vault_m.pubkey != vault_pda:
            raise ProgramError("invalid seeds")
        config_acc = self.account(config_pda)
        if config_acc.data or config_acc.lamports:
            raise ProgramError("account already initialized")
        config_acc.data = encode_config(
            sequencer_authority, domain, b"\x00" * 32, 0, config_bump, True
        )
        config_acc.owner = BRIDGE_PROGRAM_ID
        config_acc.lamports = 1  # rent-exempt marker
        vault_acc = self.account(vault_pda)
        vault_acc.data = domain + bytes([vault_bump]) + b"\x00" * 7
        vault_acc.owner = BRIDGE_PROGRAM_ID
        self.log(f"ZE_INIT:{domain.hex()}")

    def _deposit(self, ix: Instruction, body: bytes):
        """instruction/deposit.rs."""
        if len(ix.accounts) < 5:
            raise ProgramError("not enough account keys")
        depositor, config_m, vault_m, receipt_m = (
            ix.accounts[0], ix.accounts[1], ix.accounts[2], ix.accounts[3])
        self._check_signer(depositor)
        if len(body) < 16:
            raise ProgramError("bad deposit params")
        amount, nonce = struct.unpack("<QQ", body[:16])
        if amount == 0:
            raise ProgramError("invalid instruction data")
        config = decode_config(self.account(config_m.pubkey).data)
        if not config["is_initialized"]:
            raise ProgramError("uninitialized account")
        domain = config["domain"]
        vault_pda, _ = derive_vault_pda(domain)
        if vault_m.pubkey != vault_pda:
            raise ProgramError("invalid seeds")
        receipt_pda, receipt_bump = derive_deposit_receipt_pda(
            domain, depositor.pubkey, nonce)
        if receipt_m.pubkey != receipt_pda:
            raise ProgramError("invalid seeds")
        receipt_acc = self.account(receipt_pda)
        if receipt_acc.data:
            raise ProgramError("account already initialized")  # dedup
        dep_acc = self.account(depositor.pubkey)
        if dep_acc.lamports < amount:
            raise ProgramError("insufficient funds")
        dep_acc.lamports -= amount
        self.account(vault_pda).lamports += amount
        receipt_acc.data = encode_receipt(
            depositor.pubkey, domain, amount, nonce, self.clock, receipt_bump)
        receipt_acc.owner = BRIDGE_PROGRAM_ID
        self.log(
            f"ZE_DEPOSIT:{depositor.pubkey.hex()}:{amount}:{nonce}")

    def _withdraw_attested(self, ix: Instruction, body: bytes):
        """instruction/withdraw.rs."""
        if len(ix.accounts) < 6:
            raise ProgramError("not enough account keys")
        sequencer, config_m, vault_m, recipient_m, nullifier_m = (
            ix.accounts[0], ix.accounts[1], ix.accounts[2], ix.accounts[3],
            ix.accounts[4])
        self._check_signer(sequencer)
        config = decode_config(self.account(config_m.pubkey).data)
        if not config["is_initialized"]:
            raise ProgramError("uninitialized account")
        if sequencer.pubkey != config["sequencer_authority"]:
            raise ProgramError("incorrect authority")
        domain = config["domain"]
        if len(body) < 72:
            raise ProgramError("bad withdraw params")
        recipient = body[0:32]
        amount = struct.unpack("<Q", body[32:40])[0]
        nullifier = body[40:72]
        if amount == 0:
            raise ProgramError("invalid instruction data")
        vault_pda, _ = derive_vault_pda(domain)
        if vault_m.pubkey != vault_pda:
            raise ProgramError("invalid seeds")
        nullifier_pda, bump = derive_nullifier_pda(domain, nullifier)
        if nullifier_m.pubkey != nullifier_pda:
            raise ProgramError("invalid seeds")
        nf_acc = self.account(nullifier_pda)
        if nf_acc.data:
            raise ProgramError("replay attempt")  # withdraw.rs:74-76
        vault = self.account(vault_pda)
        if vault.lamports < amount:
            raise ProgramError("insufficient vault funds")
        nf_acc.data = encode_nullifier(domain, nullifier, recipient, amount,
                                       bump)
        nf_acc.owner = BRIDGE_PROGRAM_ID
        vault.lamports -= amount
        self.account(recipient_m.pubkey).lamports += amount
        self.log(f"withdraw:{amount}")
        self.log(f"ts:{self.clock}")

    def _submit_batch(self, ix: Instruction, body: bytes):
        """instruction/submit_batch.rs:165-325."""
        if len(ix.accounts) < 4:
            raise ProgramError("not enough account keys")
        sequencer = ix.accounts[0]
        config_m = ix.accounts[1]
        verifier_m = ix.accounts[2]
        vk_m = ix.accounts[3]
        recipients = ix.accounts[4:]
        self._check_signer(sequencer)
        config_acc = self.account(config_m.pubkey)
        config = decode_config(config_acc.data)
        if not config["is_initialized"]:
            raise ProgramError("uninitialized account")
        if sequencer.pubkey != config["sequencer_authority"]:
            raise ProgramError("incorrect authority")
        domain = config["domain"]

        if len(body) < HEADER_LEN:
            raise ProgramError("invalid instruction data")
        prev_idx, new_idx = struct.unpack("<QQ", body[0:16])
        new_state_root = body[16:48]
        proof_len, wd_count = struct.unpack("<II", body[48:56])
        if prev_idx != config["batch_index"]:
            raise ProgramError("invalid prev_batch_index")
        if new_idx != config["batch_index"] + 1:
            raise ProgramError("invalid new_batch_index")
        if proof_len != PROOF_LEN:
            raise ProgramError("invalid proof length")
        off = HEADER_LEN
        proof = body[off:off + PROOF_LEN]
        if len(proof) != PROOF_LEN:
            raise ProgramError("invalid instruction data")
        off += PROOF_LEN
        pi = body[off:off + PUBLIC_INPUTS_LEN]
        if len(pi) != PUBLIC_INPUTS_LEN:
            raise ProgramError("missing public inputs")
        off += PUBLIC_INPUTS_LEN
        if pi[32:64] != new_state_root:
            raise ProgramError("public inputs state root mismatch")
        batch_id = struct.unpack("<Q", pi[192:200])[0]
        if batch_id != new_idx:
            raise ProgramError("public inputs batch_id mismatch")

        # CPI to the verifier (submit_batch.rs:268-282)
        cpi_data = VERIFY_BATCH_PROOF_DISCRIMINATOR + proof + pi
        self._process_verifier(Instruction(
            program_id=verifier_m.pubkey,
            accounts=[AccountMeta(sequencer.pubkey, True), vk_m],
            data=cpi_data,
        ))
        self.log("ZK proof verified successfully")

        # withdrawal intents (submit_batch.rs:287-315)
        if len(recipients) != wd_count:
            raise ProgramError("invalid account data")
        for i in range(wd_count):
            start = off + i * WITHDRAWAL_LEN
            w = body[start:start + WITHDRAWAL_LEN]
            if len(w) != WITHDRAWAL_LEN:
                raise ProgramError("invalid instruction data")
            recipient = w[0:32]
            amount = struct.unpack("<Q", w[32:40])[0]
            if recipients[i].pubkey != recipient:
                raise ProgramError("invalid account data")
            self.log(f"ZE_WITHDRAW_INTENT:{recipient.hex()}:{amount}")

        cfg = decode_config(config_acc.data)
        config_acc.data = encode_config(
            cfg["sequencer_authority"], domain, new_state_root, new_idx,
            cfg["bump"], True,
        )
        self.log(f"ZE_BATCH_FINALIZED:{domain.hex()}:{new_idx}")
