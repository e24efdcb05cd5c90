"""In-process model of the deployed on-chain Groth16 verifier program.

Re-implements onchain-programs/verifier `verify_batch_proof`
(onchain_verifier/src/lib.rs:438-545) byte-for-byte over the alt_bn128
syscall model (solana_syscalls.py), playing the role the reference's
litesvm-hosted program plays in its tests: the final acceptance gate a
proof from the card must pass before the bridge finalizes a batch.

Byte conventions -- matching what the DEPLOYED program actually consumes:
- Solana's alt_bn128_* syscalls are EVM-convention: 32-byte BIG-ENDIAN
  field elements, G2 with the imaginary coefficient first. The verifier
  feeds raw instruction/account bytes straight into them (lib.rs:497-545),
  so proof points, VK points, and public-input scalars are all BE on the
  wire.
- batch public inputs: seven raw 32-byte arrays with batch_id big-endian
  in the last 8 bytes (lib.rs:479-494).
- scalar-in-field validation compares big-endian bytes against the BASE
  field modulus q (lib.rs:648-654) -- the deployed program really checks
  q, not the scalar field r; reproduced as-is.
- pi_a arrives PRE-NEGATED (the pairing uses it directly; the reference's
  arkworks->Solana conversion helper negates, lib.rs:708-724).

NOTE(reference bug, fixed on our prover side): the reference PROVER
serializes proof points and roots little-endian
(core/src/sequencer/settlement/prover.rs:304-334) -- bytes the deployed
program would misread as big-endian, so its Groth16 proofs could never
verify on-chain (it only ever ran MockProver end-to-end). This framework
fixes the prover: prover_service.proof_to_solana_bytes and the settler
emit big-endian, and this model consumes exactly what the deployed
program consumes.
"""

from __future__ import annotations

from typing import List

from ..fields.bn254 import P as Q_MOD
from ..groth16.keys import VerifyingKey
from .prover_service import BatchProof
from .solana_syscalls import (
    SyscallError,
    alt_bn128_addition,
    alt_bn128_multiplication,
    alt_bn128_pairing,
    encode_g1,
    encode_g2,
)

MAX_IC_POINTS = 8


def batch_inputs_to_field_elements(inputs) -> List[bytes]:
    """lib.rs:479-494 passes the instruction's raw 32-byte arrays through
    (batch_id as 32-byte BE). The arrays the settler puts in the
    instruction are the big-endian VALUE serializations
    (prover_service.batch_inputs_to_solana_bytes) -- the settler-side fix
    for the reference's LE/BE mismatch."""
    from .prover_service import batch_inputs_to_solana_bytes

    return batch_inputs_to_solana_bytes(inputs)


def verify_scalar_in_field(x_bytes: bytes) -> bool:
    """lib.rs:648-654: big-endian byte comparison against the BASE field
    modulus q (the deployed program's actual check)."""
    return int.from_bytes(x_bytes, "big") < Q_MOD


def verify_groth16_with_alt_bn254(pi_a: bytes, pi_b: bytes, pi_c: bytes,
                                  input_bytes: List[bytes],
                                  vk_solana: dict) -> bool:
    """lib.rs:497-545 over the syscall model. vk_solana holds the stored
    account bytes: alpha_g1 (64), beta_g2/gamma_g2/delta_g2 (128), ic
    (list of 64). pi_a must be pre-negated."""
    if len(vk_solana["ic"]) != len(input_bytes) + 1:
        return False
    for b in input_bytes:
        if not verify_scalar_in_field(b):
            return False
    try:
        vk_x = vk_solana["ic"][0]
        for i, inp in enumerate(input_bytes):
            mul_res = alt_bn128_multiplication(vk_solana["ic"][i + 1] + inp)
            vk_x = alt_bn128_addition(mul_res + vk_x)
        pairing_input = (
            pi_a + pi_b
            + vk_x + vk_solana["gamma_g2"]
            + pi_c + vk_solana["delta_g2"]
            + vk_solana["alpha_g1"] + vk_solana["beta_g2"]
        )
        res = alt_bn128_pairing(pairing_input)
    except SyscallError:
        return False
    return res[31] == 1 and res[:31] == b"\x00" * 31


def vk_to_solana_account(vk: VerifyingKey) -> dict:
    """The verifier program's stored VK account bytes (big-endian, EVM G2
    ordering) -- what init_batch_vk/append_ic_points must upload for the
    syscalls to read the points correctly."""
    return {
        "alpha_g1": encode_g1(vk.alpha_g1),
        "beta_g2": encode_g2(vk.beta_g2),
        "gamma_g2": encode_g2(vk.gamma_g2),
        "delta_g2": encode_g2(vk.delta_g2),
        "ic": [encode_g1(pt) for pt in vk.gamma_abc_g1],
    }


def verify_batch_proof(vk: VerifyingKey, proof: BatchProof) -> bool:
    """lib.rs:438-475: the CPI entrypoint the bridge calls."""
    if len(proof.proof_bytes) != 256:
        return False
    input_bytes = batch_inputs_to_field_elements(proof.public_inputs)
    if len(vk.gamma_abc_g1) != len(input_bytes) + 1:
        return False
    data = proof.proof_bytes
    return verify_groth16_with_alt_bn254(
        data[0:64], data[64:192], data[192:256], input_bytes,
        vk_to_solana_account(vk),
    )


# ---------------------------------------------------------------------------
# RISC0 receipt verification path (verifier lib.rs:309-341, 550-650)
# ---------------------------------------------------------------------------
#
# The deployed program derives the RISC0 claim digest (sha256 tag-hashing of
# the receipt claim structure), splits it with the allowed control root
# into five BN254 field elements, and runs the "temporarily simplified"
# verification -- the reference only range-checks the scalars and logs
# that a production build would use the embedded RISC0 VK. Modeled
# byte-for-byte, including the placeholder semantics (documented, not
# hidden).

import hashlib as _hashlib

RISC0_ALLOWED_CONTROL_ROOT = bytes.fromhex(
    "8cdad9242664be3112aba377c5425a4df735eb1c6966472b561d2855932c0469")
RISC0_BN254_IDENTITY_CONTROL_ID = bytes.fromhex(
    "c07a65145c3cb48b6101962ea607a4dd93c753bb26975cb47feb00d3666e4404")
RISC0_OUTPUT_TAG = bytes.fromhex(
    "77eafeb366a78b47747de0d7bb176284085ff5564887009a5be63da32d3559d4")
RISC0_RECEIPT_CLAIM_TAG = bytes.fromhex(
    "cb1fefcd1f2d9a64975cbbbf6e161e2914434b0cbb9960b84df5d717e86b48af")
RISC0_SYSTEM_STATE_ZERO_DIGEST = bytes.fromhex(
    "a3acc27117418996340b84e5a90f3ef4c49d22c79e44aad822ec9c313e1eb8e2")


def _sha(*parts: bytes) -> bytes:
    h = _hashlib.sha256()
    for p in parts:
        h.update(p)
    return h.digest()


def hash_risc0_output(journal_digest: bytes,
                      assumptions_digest: bytes = b"\x00" * 32) -> bytes:
    down_len = (2 << 8).to_bytes(2, "big")
    return _sha(RISC0_OUTPUT_TAG, journal_digest, assumptions_digest,
                down_len)


def hash_receipt_claim(input_digest: bytes, pre_state: bytes,
                       post_state: bytes, output_digest: bytes,
                       system_exit: int, user_exit: int) -> bytes:
    system_bytes = ((system_exit << 24) & 0xFFFFFFFF).to_bytes(4, "big")
    user_bytes = ((user_exit << 24) & 0xFFFFFFFF).to_bytes(4, "big")
    down_len = (4 << 8).to_bytes(2, "big")
    return _sha(RISC0_RECEIPT_CLAIM_TAG, input_digest, pre_state,
                post_state, output_digest, system_bytes, user_bytes,
                down_len)


def hash_risc0_claim(image_id: bytes, journal_digest: bytes) -> bytes:
    return hash_receipt_claim(
        b"\x00" * 32, image_id, RISC0_SYSTEM_STATE_ZERO_DIGEST,
        hash_risc0_output(journal_digest), 0, 0,
    )


def _split_digest(digest: bytes):
    """lib.rs:636-640: reverse to big-endian, split, zero-extend halves."""
    be = digest[::-1]
    b, a = be[:16], be[16:]
    return (b"\x00" * 16 + a, b"\x00" * 16 + b)


def risc0_public_inputs(claim_digest: bytes) -> List[bytes]:
    """lib.rs:618-633: [control_root lo/hi, claim lo/hi, control id]."""
    if claim_digest == b"\x00" * 32:
        raise ValueError("invalid claim digest")
    a0, a1 = _split_digest(RISC0_ALLOWED_CONTROL_ROOT)
    c0, c1 = _split_digest(claim_digest)
    return [a0, a1, c0, c1, RISC0_BN254_IDENTITY_CONTROL_ID[::-1]]


def verify_risc0_proof(proof_bytes: bytes, image_id: bytes,
                       journal_digest: bytes) -> bool:
    """The deployed `verify_risc0_proof` entry: claim digest -> public
    inputs -> scalar range checks. The reference's pairing leg is a
    DOCUMENTED placeholder ("temporarily simplified", lib.rs:550-563) --
    faithfully modeled as such."""
    claim = hash_risc0_claim(image_id, journal_digest)
    inputs = risc0_public_inputs(claim)
    return all(verify_scalar_in_field(b) for b in inputs)
