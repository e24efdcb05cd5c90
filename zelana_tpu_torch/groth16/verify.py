"""Groth16 verification (host-side pairing check).

Same equation as the on-chain verifier
(onchain_verifier/src/lib.rs:497-545):

    e(A, B) = e(alpha, beta) * e(vk_x, gamma) * e(C, delta)
    vk_x = IC[0] + sum_i input_i * IC[i+1]

expressed as a 4-pair product with a single final exponentiation, which is
exactly the alt_bn128_pairing input list the verifier program builds
(lib.rs:523-534: [-A, B, vk_x, gamma, C, delta, alpha, beta]).
"""

from __future__ import annotations

from typing import List

from ..curves import g1 as G1
from ..curves.pairing import pairing_product_is_one
from .keys import Proof, VerifyingKey


def prepare_vk_x(vk: VerifyingKey, public_inputs: List[int]):
    assert len(public_inputs) + 1 == len(vk.gamma_abc_g1), (
        f"expected {len(vk.gamma_abc_g1) - 1} public inputs, "
        f"got {len(public_inputs)}"
    )
    acc = vk.gamma_abc_g1[0]
    for x, pt in zip(public_inputs, vk.gamma_abc_g1[1:]):
        acc = G1.add(acc, G1.mul(pt, x))
    return acc


def verify(vk: VerifyingKey, proof: Proof, public_inputs: List[int]) -> bool:
    vk_x = prepare_vk_x(vk, public_inputs)
    return pairing_product_is_one(
        [
            (G1.neg(proof.a), proof.b),
            (vk.alpha_g1, vk.beta_g2),
            (vk_x, vk.gamma_g2),
            (proof.c, vk.delta_g2),
        ]
    )
