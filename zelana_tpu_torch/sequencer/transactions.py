"""Transaction types (mirror of sdk/transaction, zelana-transaction crate).

Four kinds (sdk/transaction/src/lib.rs:12-25): Shielded, Transfer, Deposit,
Withdraw. JSON-friendly dataclasses with a canonical signing message format
echoing the SDK's human-readable signed message (sdk/keypair/src/lib.rs).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass
class Transfer:
    signer_pubkey: bytes  # 32
    to: bytes  # 32
    amount: int
    nonce: int
    signature: bytes = b""  # 64

    def signing_message(self) -> bytes:
        return (
            b"zelana:transfer:v1\n"
            + self.signer_pubkey
            + self.to
            + self.amount.to_bytes(8, "little")
            + self.nonce.to_bytes(8, "little")
        )


@dataclass
class Deposit:
    to: bytes
    amount: int
    l1_seq: int


@dataclass
class Withdraw:
    from_: bytes
    to_l1_address: bytes
    amount: int
    nonce: int
    signature: bytes = b""

    def signing_message(self) -> bytes:
        return (
            b"zelana:withdraw:v1\n"
            + self.from_
            + self.to_l1_address
            + self.amount.to_bytes(8, "little")
            + self.nonce.to_bytes(8, "little")
        )


@dataclass
class Shielded:
    """PrivateTransaction (sdk/transaction/src/lib.rs:27-55)."""

    proof: bytes
    nullifier: bytes  # 32
    commitment: bytes  # 32
    ciphertext: bytes = b""
    merkle_root: bytes = b""
    # transparent <-> shielded moves
    shield_from: Optional[bytes] = None
    shield_amount: int = 0
    unshield_to: Optional[bytes] = None
    unshield_amount: int = 0


TransactionType = (Transfer, Deposit, Withdraw, Shielded)


def tx_kind(tx) -> str:
    return type(tx).__name__.lower()
