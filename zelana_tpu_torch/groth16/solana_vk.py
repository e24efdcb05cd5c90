"""VK conversion to the on-chain (Solana) format + chunked upload layout.

The verifier program stores VK points as raw account bytes and feeds them
straight into Solana's alt_bn128 syscalls (lib.rs:497-545), which are
EVM-convention: 32-byte BIG-ENDIAN coordinates, G2 with the imaginary
coefficient first (EIP-197). `convert_vk` emits that deployed-correct
format.

NOTE(reference bug): the reference's convert_vk.rs:163-190 writes
little-endian, c0-first bytes -- a VK the syscalls would misread (same
LE/BE family as settlement/prover.rs:304-334). `convert_vk_reference_le`
mirrors it for byte-parity tests; `convert_vk` is what actually verifies.

Also here: the chunked IC upload plan used by scripts/store_vk.rs
(init_batch_vk / append_ic_points / finalize, verifier lib.rs:379-433,
MAX_IC_POINTS=8).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import List

from .keys import VerifyingKey

MAX_IC_POINTS = 8


def g1_to_solana(pt) -> bytes:
    """64 bytes x||y, big-endian (syscall convention)."""
    if pt is None:
        return b"\x00" * 64
    return int(pt[0]).to_bytes(32, "big") + int(pt[1]).to_bytes(32, "big")


def g2_to_solana(pt) -> bytes:
    """128 bytes x_c1||x_c0||y_c1||y_c0, big-endian (EIP-197 order)."""
    if pt is None:
        return b"\x00" * 128
    (x0, x1), (y0, y1) = pt
    return (
        int(x1).to_bytes(32, "big")
        + int(x0).to_bytes(32, "big")
        + int(y1).to_bytes(32, "big")
        + int(y0).to_bytes(32, "big")
    )


def g1_to_reference_le(pt) -> bytes:
    """The reference convert_vk.rs byte layout (little-endian, c0-first) --
    kept only as a parity artifact of the documented reference bug."""
    if pt is None:
        return b"\x00" * 64
    return int(pt[0]).to_bytes(32, "little") + int(pt[1]).to_bytes(32, "little")


def g2_to_reference_le(pt) -> bytes:
    if pt is None:
        return b"\x00" * 128
    (x0, x1), (y0, y1) = pt
    return (
        int(x0).to_bytes(32, "little")
        + int(x1).to_bytes(32, "little")
        + int(y0).to_bytes(32, "little")
        + int(y1).to_bytes(32, "little")
    )


@dataclass
class SolanaVk:
    alpha_g1: bytes  # 64
    beta_g2: bytes  # 128
    gamma_g2: bytes  # 128
    delta_g2: bytes  # 128
    ic: List[bytes]  # 64 each

    def to_json(self) -> str:
        return json.dumps(
            {
                "alpha_g1": self.alpha_g1.hex(),
                "beta_g2": self.beta_g2.hex(),
                "gamma_g2": self.gamma_g2.hex(),
                "delta_g2": self.delta_g2.hex(),
                "ic": [p.hex() for p in self.ic],
            },
            indent=2,
        )


def convert_vk(vk: VerifyingKey) -> SolanaVk:
    assert len(vk.gamma_abc_g1) <= MAX_IC_POINTS, (
        f"verifier stores at most {MAX_IC_POINTS} IC points "
        f"({len(vk.gamma_abc_g1)} given)"
    )
    return SolanaVk(
        alpha_g1=g1_to_solana(vk.alpha_g1),
        beta_g2=g2_to_solana(vk.beta_g2),
        gamma_g2=g2_to_solana(vk.gamma_g2),
        delta_g2=g2_to_solana(vk.delta_g2),
        ic=[g1_to_solana(p) for p in vk.gamma_abc_g1],
    )


def convert_vk_reference_le(vk: VerifyingKey) -> SolanaVk:
    """Byte-identical mirror of the reference convert_vk.rs output."""
    return SolanaVk(
        alpha_g1=g1_to_reference_le(vk.alpha_g1),
        beta_g2=g2_to_reference_le(vk.beta_g2),
        gamma_g2=g2_to_reference_le(vk.gamma_g2),
        delta_g2=g2_to_reference_le(vk.delta_g2),
        ic=[g1_to_reference_le(p) for p in vk.gamma_abc_g1],
    )


def upload_plan(svk: SolanaVk, domain: bytes = b"\x00" * 32,
                chunk: int = 4) -> List[dict]:
    """The store_vk.rs instruction sequence: init -> append IC in chunks ->
    finalize."""
    plan = [
        {
            "instruction": "init_batch_vk",
            "domain": domain.hex(),
            "alpha_g1": svk.alpha_g1.hex(),
            "beta_g2": svk.beta_g2.hex(),
            "gamma_g2": svk.gamma_g2.hex(),
            "delta_g2": svk.delta_g2.hex(),
        }
    ]
    for i in range(0, len(svk.ic), chunk):
        plan.append(
            {
                "instruction": "append_ic_points",
                "ic_points": [p.hex() for p in svk.ic[i : i + chunk]],
            }
        )
    plan.append({"instruction": "finalize_batch_vk"})
    return plan


# ---------------------------------------------------------------------------
# snarkjs-style VK export (prover/src/snarkjs.rs:113-137)
# ---------------------------------------------------------------------------


def export_vk_snarkjs(vk: VerifyingKey) -> dict:
    """snarkjs-compatible VK JSON: decimal coordinate strings, G1 as
    [x, y, "1"], G2 as [[c1, c0], ...] pairs with the imaginary part first
    (snarkjs.rs fq2_to_pair_snarkjs), omitting vk_alphabeta_12 exactly as
    the reference does."""

    def g1(pt):
        if pt is None:
            return ["0", "1", "0"]
        return [str(int(pt[0])), str(int(pt[1])), "1"]

    def g2(pt):
        if pt is None:
            return [["0", "0"], ["1", "0"], ["0", "0"]]
        (x0, x1), (y0, y1) = pt
        return [
            [str(int(x1)), str(int(x0))],
            [str(int(y1)), str(int(y0))],
            ["1", "0"],
        ]

    return {
        "protocol": "groth16",
        "curve": "bn128",
        "nPublic": len(vk.gamma_abc_g1) - 1,
        "vk_alpha_1": g1(vk.alpha_g1),
        "vk_beta_2": g2(vk.beta_g2),
        "vk_gamma_2": g2(vk.gamma_g2),
        "vk_delta_2": g2(vk.delta_g2),
        "IC": [g1(p) for p in vk.gamma_abc_g1],
    }
