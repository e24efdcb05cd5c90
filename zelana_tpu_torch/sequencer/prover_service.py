"""Proof encoding for the deployed Solana verifier.

Only the wire format of the prover service is needed by the chunk prover:
``proof_to_solana_bytes`` and its inverse ``solana_bytes_to_proof``.
"""

from __future__ import annotations

from ..groth16.keys import Proof


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
