"""Prover-network wire messages (mirror of forge/crates/prover-network).

JSON-serializable request/response types for the distributed proving
services (prover-network/src/messages.rs:12-293): circuit selection,
Shamir share distribution, Schnorr nonce commitments and proof fragments
(plus the blind variants where the node never sees the statement), chunk
prove requests between coordinator and workers, and proof results.

Field elements travel as hex strings; G1 points travel as compressed
arkworks hex (the reference uses ark-serialize inside serde wrappers,
prover-network/src/serialization_test.rs).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, List, Optional

from ..curves import g1 as G1


class CircuitType(str, Enum):
    SCHNORR = "schnorr"
    HASH_PREIMAGE = "hash_preimage"
    COMMITMENT = "commitment"
    BATCH = "batch"
    OWNERSHIP = "ownership"


# -- field / point codecs ----------------------------------------------------


def fr_to_hex(x: int) -> str:
    return format(x, "064x")


def fr_from_hex(s: str) -> int:
    return int(s, 16)


def point_to_hex(pt) -> str:
    return G1.serialize_compressed(pt).hex()


def point_from_hex(s: str):
    return G1.deserialize_compressed(bytes.fromhex(s))


# -- Shamir share distribution -------------------------------------------------


@dataclass
class ShareRequest:
    session_id: str
    circuit: CircuitType
    index: int
    share_value: str  # hex Fr (X25519-encrypted in the committee flow)

    def to_json(self) -> dict:
        return {"session_id": self.session_id, "circuit": self.circuit.value,
                "index": self.index, "share_value": self.share_value}

    @classmethod
    def from_json(cls, d: dict) -> "ShareRequest":
        return cls(d["session_id"], CircuitType(d["circuit"]),
                   int(d["index"]), d["share_value"])


@dataclass
class ShareResponse:
    session_id: str
    accepted: bool
    error: Optional[str] = None

    def to_json(self) -> dict:
        return {"session_id": self.session_id, "accepted": self.accepted,
                "error": self.error}

    @classmethod
    def from_json(cls, d: dict) -> "ShareResponse":
        return cls(d["session_id"], bool(d["accepted"]), d.get("error"))


# -- Schnorr round 1: nonce commitments ------------------------------------------


@dataclass
class CommitmentRequest:
    session_id: str
    # blind variant: the node commits without seeing the message
    # (prover-network messages.rs blind requests)
    blind: bool = False

    def to_json(self) -> dict:
        return {"session_id": self.session_id, "blind": self.blind}

    @classmethod
    def from_json(cls, d: dict) -> "CommitmentRequest":
        return cls(d["session_id"], bool(d.get("blind", False)))


@dataclass
class CommitmentResponse:
    session_id: str
    index: int
    r_point: str  # compressed G1 hex

    def to_json(self) -> dict:
        return {"session_id": self.session_id, "index": self.index,
                "r_point": self.r_point}

    @classmethod
    def from_json(cls, d: dict) -> "CommitmentResponse":
        return cls(d["session_id"], int(d["index"]), d["r_point"])


# -- Schnorr round 2: proof fragments ---------------------------------------------


@dataclass
class FragmentRequest:
    session_id: str
    challenge: str  # hex Fr
    lagrange: str  # hex Fr — coordinator-computed Lagrange coefficient

    def to_json(self) -> dict:
        return {"session_id": self.session_id, "challenge": self.challenge,
                "lagrange": self.lagrange}

    @classmethod
    def from_json(cls, d: dict) -> "FragmentRequest":
        return cls(d["session_id"], d["challenge"], d["lagrange"])


@dataclass
class FragmentResponse:
    session_id: str
    index: int
    z: str  # hex Fr fragment

    def to_json(self) -> dict:
        return {"session_id": self.session_id, "index": self.index,
                "z": self.z}

    @classmethod
    def from_json(cls, d: dict) -> "FragmentResponse":
        return cls(d["session_id"], int(d["index"]), d["z"])


# -- coordinator <-> worker chunk proving ---------------------------------------------


@dataclass
class ChunkProveRequest:
    """One fixed-capacity circuit chunk (prover-worker/src/prover.rs
    ChunkInputs; capacities 8/4/4 per zelana_batch/main.nr:27-30)."""

    batch_id: int
    chunk_index: int
    pre_state_root: str
    post_state_root: str
    pre_shielded_root: str
    post_shielded_root: str
    transfers: List[dict] = field(default_factory=list)
    withdrawals: List[dict] = field(default_factory=list)
    shielded: List[dict] = field(default_factory=list)

    def to_json(self) -> dict:
        return {
            "batch_id": self.batch_id, "chunk_index": self.chunk_index,
            "pre_state_root": self.pre_state_root,
            "post_state_root": self.post_state_root,
            "pre_shielded_root": self.pre_shielded_root,
            "post_shielded_root": self.post_shielded_root,
            "transfers": self.transfers, "withdrawals": self.withdrawals,
            "shielded": self.shielded,
        }

    @classmethod
    def from_json(cls, d: dict) -> "ChunkProveRequest":
        return cls(
            batch_id=int(d["batch_id"]), chunk_index=int(d["chunk_index"]),
            pre_state_root=d["pre_state_root"],
            post_state_root=d["post_state_root"],
            pre_shielded_root=d.get("pre_shielded_root", fr_to_hex(0)),
            post_shielded_root=d.get("post_shielded_root", fr_to_hex(0)),
            transfers=list(d.get("transfers", [])),
            withdrawals=list(d.get("withdrawals", [])),
            shielded=list(d.get("shielded", [])),
        )


@dataclass
class ProofResult:
    """Worker proof result (prover-worker ProofResult): proof bytes +
    ordered public inputs + timing, Solana-instruction-convertible."""

    chunk_index: int
    proof: str  # hex proof bytes
    public_inputs: List[str]  # hex Fr, verifier order
    proving_time_ms: int

    def to_json(self) -> dict:
        return {"chunk_index": self.chunk_index, "proof": self.proof,
                "public_inputs": self.public_inputs,
                "proving_time_ms": self.proving_time_ms}

    @classmethod
    def from_json(cls, d: dict) -> "ProofResult":
        return cls(int(d["chunk_index"]), d["proof"],
                   list(d["public_inputs"]), int(d["proving_time_ms"]))

    def to_solana_instruction_data(self, discriminator: int = 3) -> bytes:
        """Sunspot submit format (coordinator solana_client.rs:1-11):
        discriminator + proof + 4B count + 8B pad + 32B BE inputs."""
        proof = bytes.fromhex(self.proof)
        out = bytes([discriminator]) + proof
        out += len(self.public_inputs).to_bytes(4, "little") + b"\x00" * 8
        for h in self.public_inputs:
            out += fr_from_hex(h).to_bytes(32, "big")
        return out


# -- ownership (delegated proving) ------------------------------------------------


@dataclass
class OwnershipProveRequest:
    """Synchronous delegated ownership proof request
    (prover-coordinator/src/ownership_api.rs:1-45): the private witness
    plus the expected public values the prover must reproduce."""

    spending_key: str
    value: str
    blinding: str
    position: int
    expected_commitment: str
    expected_nullifier: str
    expected_blinded_proxy: str

    def to_json(self) -> dict:
        return {
            "spending_key": self.spending_key, "value": self.value,
            "blinding": self.blinding, "position": self.position,
            "expected_commitment": self.expected_commitment,
            "expected_nullifier": self.expected_nullifier,
            "expected_blinded_proxy": self.expected_blinded_proxy,
        }

    @classmethod
    def from_json(cls, d: dict) -> "OwnershipProveRequest":
        return cls(d["spending_key"], d["value"], d["blinding"],
                   int(d["position"]), d["expected_commitment"],
                   d["expected_nullifier"], d["expected_blinded_proxy"])
