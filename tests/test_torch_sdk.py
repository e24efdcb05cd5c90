"""The port's client SDK host modules (zelana_tpu_torch.sdk.privacy,
ownership, txblob, block) against the JAX package's on seeded inputs, with
exact equality; notes and transaction blobs encrypted by one package and
decrypted by the other; and the port's Poseidon BLS12-381 commitments and
ownership chain against the TypeScript SDK's committed vectors
(sdk/typescript/test/vectors.json)."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from zelana_tpu.sdk import block as JB
from zelana_tpu.sdk import ownership as JO
from zelana_tpu.sdk import privacy as JP
from zelana_tpu.sdk import txblob as JT
from zelana_tpu_torch.sdk import aead
from zelana_tpu_torch.sdk import block as TB
from zelana_tpu_torch.sdk import ownership as TO
from zelana_tpu_torch.sdk import privacy as TP
from zelana_tpu_torch.sdk import txblob as TT

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TS_VECTORS = os.path.join(ROOT, "sdk", "typescript", "test", "vectors.json")


@pytest.fixture
def urandom(monkeypatch):
    """os.urandom from a seeded generator, reset to the seed on each call
    of the fixture's value: both packages then draw the same ephemeral keys
    and nonces."""
    state = {}

    def reset(seed: int):
        state["rng"] = np.random.default_rng(seed)

    monkeypatch.setattr(os, "urandom", lambda n: state["rng"].bytes(n))
    return reset


def test_privacy_equal_jax():
    rng = np.random.default_rng(20)
    for _ in range(3):
        value = int(rng.integers(0, 1 << 63))
        r, pk, asset, sk = (rng.bytes(32) for _ in range(4))
        pos = int(rng.integers(0, 1 << 32))
        assert TP.commit(value, r, pk) == JP.commit(value, r, pk)
        assert TP.Note(value, r, pk).commitment() == \
            JP.Note(value, r, pk).commitment()
        assert TP.commit_extended(value, r, pk, asset) == \
            JP.commit_extended(value, r, pk, asset)
        cm = TP.commit(value, r, pk)
        assert TP.derive_nullifier(sk, cm, pos) == \
            JP.derive_nullifier(sk, cm, pos)
        assert TP.derive_nk(sk) == JP.derive_nk(sk)
        note = TP.Note(value, r, pk)
        assert note.to_json() == JP.Note(value, r, pk).to_json()
        assert TP.Note.from_json(note.to_json()) == note


def test_ownership_equal_jax():
    rng = np.random.default_rng(21)
    for _ in range(3):
        sk, value, blinding, pos = (int(rng.integers(1, 1 << 62))
                                    for _ in range(4))
        w = TO.OwnershipWitness.generate(sk, value, blinding, pos)
        assert dataclasses.astuple(w) == dataclasses.astuple(
            JO.OwnershipWitness.generate(sk, value, blinding, pos))
        assert w.check()
        w.note_position += 1
        assert not w.check()
        skb, cmb = rng.bytes(32), rng.bytes(32)
        assert TO.derive_public_key_bytes(skb) == \
            JO.derive_public_key_bytes(skb)
        assert TO.compute_commitment_bytes(skb, value, cmb) == \
            JO.compute_commitment_bytes(skb, value, cmb)
        assert TO.compute_nullifier_bytes(skb, cmb, pos) == \
            JO.compute_nullifier_bytes(skb, cmb, pos)
        assert TO.compute_blinded_proxy_bytes(cmb, pos) == \
            JO.compute_blinded_proxy_bytes(cmb, pos)


def test_block_header_equal_jax():
    rng = np.random.default_rng(22)
    for _ in range(3):
        fields = dict(batch_id=int(rng.integers(0, 1 << 63)),
                      prev_root=rng.bytes(32), new_root=rng.bytes(32),
                      tx_count=int(rng.integers(0, 1 << 32)),
                      open_at=int(rng.integers(0, 1 << 63)),
                      flags=int(rng.integers(0, 1 << 32)))
        data = TB.BlockHeader(**fields).to_bytes()
        assert data == JB.BlockHeader(**fields).to_bytes()
        assert len(data) == TB.HEADER_SIZE == 96
        assert TB.BlockHeader.from_bytes(data) == TB.BlockHeader(**fields)
    assert TB.BlockHeader.genesis().to_bytes() == \
        JB.BlockHeader.genesis().to_bytes()
    for bad in (b"\x00" * 95, b"XXXX" + b"\x00" * 92):
        with pytest.raises(ValueError):
            TB.BlockHeader.from_bytes(bad)


def test_txblob_equal_jax(urandom):
    sk, pk = aead.x25519_keypair(b"\x09" * 32)
    for seed, hint in ((1, b""), (2, b"\x01\x02\x03\x04")):
        urandom(seed)
        got = TT.encrypt_tx(b"payload %d" % seed, pk, sender_hint=hint)
        urandom(seed)
        want = JT.encrypt_tx(b"payload %d" % seed, pk, sender_hint=hint)
        assert got.to_bytes() == want.to_bytes()
        assert dataclasses.astuple(TT.TxBlob.from_bytes(got.to_bytes())) == \
            dataclasses.astuple(got)


def test_note_encryption_equal_jax(urandom):
    sk, pk = aead.x25519_keypair(b"\x07" * 32)
    urandom(3)
    got = TP.encrypt_note(TP.Note(555, b"\x11" * 32, b"\x22" * 32), pk)
    urandom(3)
    want = JP.encrypt_note(JP.Note(555, b"\x11" * 32, b"\x22" * 32), pk)
    assert got == want
    assert TP.decrypt_note(got[:59], sk) is None  # shorter than a header


@pytest.mark.parametrize("direction", ["port->jax", "jax->port"])
def test_cross_package_decryption(direction):
    """A note and a tx blob encrypted by one package open in the other; a
    wrong key opens neither."""
    enc_p, dec_p = (TP, JP) if direction == "port->jax" else (JP, TP)
    enc_t, dec_t = (TT, JT) if direction == "port->jax" else (JT, TT)
    sk, pk = aead.x25519_keypair(b"\x07" * 32)
    other, _ = aead.x25519_keypair(b"\x08" * 32)
    blob = enc_p.encrypt_note(enc_p.Note(555, b"\x11" * 32, b"\x22" * 32),
                              pk)
    out = dec_p.decrypt_note(blob, sk)
    assert (out.value, out.randomness, out.owner_pk) == (
        555, b"\x11" * 32, b"\x22" * 32)
    assert dec_p.decrypt_note(blob, other) is None
    tx = enc_t.encrypt_tx(b"transfer:alice->bob:100", pk,
                          sender_hint=b"\xaa\xbb")
    parsed = dec_t.TxBlob.from_bytes(tx.to_bytes())
    assert dec_t.decrypt_tx(parsed, sk) == b"transfer:alice->bob:100"
    assert dec_t.decrypt_tx(parsed, other) is None
    parsed.sender_hint = b"\x09\x09"
    assert dec_t.decrypt_tx(parsed, sk) is None


def test_typescript_vectors():
    """The TypeScript SDK's vectors: Poseidon BLS12-381 8/57 over [1, 2, 3]
    (a commitment) and [10, 20, 30, 40] (an extended commitment), and the
    ownership chain of spending key 777."""
    with open(TS_VECTORS) as f:
        vectors = json.load(f)

    def b32(v):
        return int(v).to_bytes(32, "little")

    bls = vectors["poseidon_bls"]
    assert TP.commit(1, b32(2), b32(3)) == b32(bls["hash_1_2_3"])
    assert TP.commit_extended(10, b32(20), b32(30), b32(40)) == \
        b32(bls["hash_10_20_30_40"])
    own = vectors["ownership"]
    w = TO.OwnershipWitness.generate(int(own["spending_key"]), own["value"],
                                     int(own["blinding"]), own["position"])
    assert TO.derive_public_key(int(own["spending_key"])) == \
        int(own["public_key"])
    assert (w.commitment, w.nullifier, w.blinded_proxy) == (
        int(own["commitment"]), int(own["nullifier"]),
        int(own["blinded_proxy"]))
