"""Distributed Sigma-protocol proving (mirror of forge/crates/prover-core).

The forge swarm's MPC layer: Shamir secret sharing over BN254 Fr with
Lagrange reconstruction (shamir.rs:41-90), and distributed Schnorr proofs --
each node holds a share, contributes a nonce commitment and a response
fragment, and the coordinator aggregates into a proof that verifies against
the public key without any node ever holding the full secret
(schnorr.rs:50-160). Fiat-Shamir challenge via SHA-256. A hash-preimage
variant mirrors prover-core/hash_preimage.rs.

This is a host-side protocol layer (small field ops), not a device surface --
matching the reference, where it runs on commodity nodes.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass
from typing import Dict, List, Tuple

from ..curves import g1 as G1
from ..fields.bn254 import R as FR


def _rand_fr() -> int:
    while True:
        v = int.from_bytes(os.urandom(32), "little") & ((1 << 254) - 1)
        if v < FR:
            return v


# ---------------------------------------------------------------------------
# Shamir over Fr
# ---------------------------------------------------------------------------


@dataclass
class FrShare:
    index: int  # x coordinate, 1..n
    value: int


def share_secret(secret: int, k: int, n: int) -> List[FrShare]:
    assert 1 <= k <= n
    coeffs = [secret % FR] + [_rand_fr() for _ in range(k - 1)]
    shares = []
    for x in range(1, n + 1):
        acc = 0
        for c in reversed(coeffs):
            acc = (acc * x + c) % FR
        shares.append(FrShare(x, acc))
    return shares


def lagrange_coefficient(indices: List[int], i: int) -> int:
    """lambda_i for interpolation at x = 0."""
    num, den = 1, 1
    for j in indices:
        if j == i:
            continue
        num = num * (FR - j) % FR
        den = den * ((i - j) % FR) % FR
    return num * pow(den, FR - 2, FR) % FR


def reconstruct(shares: List[FrShare]) -> int:
    indices = [s.index for s in shares]
    acc = 0
    for s in shares:
        acc = (acc + s.value * lagrange_coefficient(indices, s.index)) % FR
    return acc


# ---------------------------------------------------------------------------
# distributed Schnorr
# ---------------------------------------------------------------------------


def public_key(secret: int):
    return G1.mul(G1.generator(), secret)


def _challenge(r_pt, pk, message: bytes) -> int:
    h = hashlib.sha256()
    h.update(G1.serialize_compressed(r_pt))
    h.update(G1.serialize_compressed(pk))
    h.update(message)
    return int.from_bytes(h.digest(), "little") % FR


@dataclass
class NonceCommitment:
    index: int
    r_point: tuple  # k_i * G
    _k: int = 0  # node-local nonce (never leaves the node)


@dataclass
class ProofFragment:
    index: int
    z: int


@dataclass
class SchnorrProof:
    r_point: tuple
    z: int

    def verify(self, pk, message: bytes) -> bool:
        c = _challenge(self.r_point, pk, message)
        lhs = G1.mul(G1.generator(), self.z)
        rhs = G1.add(self.r_point, G1.mul(pk, c))
        return lhs == rhs


class SchnorrNode:
    """One MPC node: holds a share, never the secret."""

    def __init__(self, share: FrShare):
        self.share = share
        self._nonce = None

    def commit(self) -> NonceCommitment:
        k = _rand_fr()
        self._nonce = k
        return NonceCommitment(self.share.index, G1.mul(G1.generator(), k), k)

    def fragment(self, challenge: int, lagrange: int) -> ProofFragment:
        assert self._nonce is not None, "commit first"
        z = (self._nonce + challenge * lagrange % FR * self.share.value) % FR
        self._nonce = None
        return ProofFragment(self.share.index, z)


class SchnorrCoordinator:
    """Aggregates commitments and fragments from k nodes."""

    def __init__(self, pk, message: bytes):
        self.pk = pk
        self.message = message

    def round1(self, commitments: List[NonceCommitment]):
        r = None
        for c in commitments:
            r = G1.add(r, c.r_point)
        self.r_point = r
        self.indices = [c.index for c in commitments]
        return _challenge(r, self.pk, self.message)

    def lagrange_for(self, index: int) -> int:
        return lagrange_coefficient(self.indices, index)

    def aggregate(self, fragments: List[ProofFragment]) -> SchnorrProof:
        z = 0
        for f in fragments:
            z = (z + f.z) % FR
        return SchnorrProof(self.r_point, z)


def distributed_schnorr_prove(secret: int, message: bytes, k: int = 3,
                              n: int = 5) -> Tuple[SchnorrProof, tuple]:
    """Full k-of-n flow (the forge swarm's 23 ms/proof pipeline shape)."""
    pk = public_key(secret)
    shares = share_secret(secret, k, n)
    nodes = [SchnorrNode(s) for s in shares[:k]]
    coord = SchnorrCoordinator(pk, message)
    commitments = [node.commit() for node in nodes]
    challenge = coord.round1(commitments)
    fragments = [
        node.fragment(challenge, coord.lagrange_for(node.share.index))
        for node in nodes
    ]
    return coord.aggregate(fragments), pk


# ---------------------------------------------------------------------------
# hash-preimage variant (prover-core/hash_preimage.rs)
# ---------------------------------------------------------------------------


@dataclass
class HashPreimageProof:
    """Sigma proof of knowledge of x with commitment C = x*G and public
    H = sha256(x_bytes). The hash binding is checked out-of-band by the
    verifier holding H; the sigma part proves knowledge of the committed x."""

    commitment: tuple
    schnorr: SchnorrProof
    hash_value: bytes


def prove_hash_preimage(preimage: bytes, k: int = 3, n: int = 5) -> HashPreimageProof:
    x = int.from_bytes(hashlib.sha256(b"hp:" + preimage).digest(), "little") % FR
    proof, pk = distributed_schnorr_prove(x, preimage, k, n)
    return HashPreimageProof(pk, proof, hashlib.sha256(preimage).digest())


def verify_hash_preimage(proof: HashPreimageProof, preimage_hint: bytes) -> bool:
    if hashlib.sha256(preimage_hint).digest() != proof.hash_value:
        return False
    return proof.schnorr.verify(proof.commitment, preimage_hint)
