"""The shielded transfer circuit of the port (zelana_tpu_torch.circuits.
shielded) against the JAX package's: the matrices, the instance count and
the full assignment of the recorded instance and of two tamperings, the
satisfaction check, NoteTree and the native helpers, all with exact
equality. The instance is built from the constants of
zelana_tpu_torch/testdata/shielded_proof.json (tools/record_service_vectors.py
shielded, the JAX keygen and prove on the CPU), each package with its own
NoteTree.

The port's keygen and prove on the CPU, byte-equal to the vector, run with
ZELANA_SLOW_TESTS=1; chip_smoke.py's `shielded` phase runs them on the
card."""

import hashlib
import json
import os
import sys

import numpy as np
import pytest
import torch

from zelana_tpu.circuits import shielded as JS
from zelana_tpu.r1cs.system import ConstraintSystem as JCS
from zelana_tpu_torch.circuits import shielded as TS
from zelana_tpu_torch.groth16.keys import ProvingKey
from zelana_tpu_torch.groth16.prove import check_fits, prove, public_inputs_of
from zelana_tpu_torch.r1cs.system import ConstraintSystem as TCS

torch.set_num_threads(1)  # many small int64 ops: threads only contend

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VECTOR = os.path.join(ROOT, "zelana_tpu_torch", "testdata",
                      "shielded_proof.json")
L2_KEY = os.path.join(ROOT, "artifacts", "l2_dummy_pk.npz")
sys.path.insert(0, os.path.join(ROOT, "tools"))
from record_service_vectors import shielded_instance  # noqa: E402

slow = pytest.mark.skipif(
    not os.environ.get("ZELANA_SLOW_TESTS"),
    reason="the shielded keygen and proof on the CPU take minutes")


def _fee_plus_one(c):
    c.fee += 1  # breaks sum(in) == sum(out) + fee


def _swap_nullifiers(c):
    c.nullifiers = [c.nullifiers[1], c.nullifiers[0]]


TAMPERS = {"recorded": None, "fee+1": _fee_plus_one,
           "nullifiers swapped": _swap_nullifiers}


@pytest.fixture(scope="module")
def vec():
    with open(VECTOR) as f:
        return json.load(f)


def _synth(S, CS, const, tamper):
    cs = CS()
    shielded_instance(S, const, tamper).generate_constraints(cs)
    return cs


@pytest.fixture(scope="module", params=list(TAMPERS))
def systems(request, vec):
    """(JAX system, port system, case) of one instance, synthesized once."""
    tamper = TAMPERS[request.param]
    return (_synth(JS, JCS, vec["instance"], tamper),
            _synth(TS, TCS, vec["instance"], tamper), request.param)


def test_constraints_equal_jax(systems, vec):
    """A, B, C, the instance count and the full assignment of each instance
    equal the JAX circuit's; the recorded one has the vector's shape (a
    2^15 domain)."""
    want, got, case = systems
    assert got.num_instance == want.num_instance == 7
    assert got.num_witness == want.num_witness
    assert got.num_constraints == want.num_constraints
    assert got.matrices() == want.matrices()
    assert got.full_assignment() == want.full_assignment()
    if case == "recorded":
        assert (got.num_instance, got.num_witness, got.num_constraints) == (
            vec["num_instance"], vec["num_witness"], vec["num_constraints"])
        assert 1 << 14 < got.num_constraints + got.num_instance <= 1 << 15


def test_is_satisfied_agrees(systems):
    want, got, case = systems
    bad = got.is_satisfied()
    assert bad == want.is_satisfied()
    assert (bad is None) == (case == "recorded")


def test_note_tree_equal():
    """Empty roots of every level, the root after each insert and every
    path equal the JAX NoteTree's."""
    rng = np.random.default_rng(15)
    jt, tt = JS.NoteTree(), TS.NoteTree()
    assert tt._empty == jt._empty and tt.root() == jt.root()
    leaves = [int.from_bytes(rng.bytes(32), "little") % TS.FR
              for _ in range(5)]
    for leaf in leaves:
        assert tt.insert(leaf) == jt.insert(leaf)
        assert tt.root() == jt.root()
    for pos in range(len(leaves)):
        assert tt.path(pos) == jt.path(pos)


def test_native_helpers_equal():
    rng = np.random.default_rng(16)
    for _ in range(3):
        sk, r, pk = rng.bytes(32), rng.bytes(32), rng.bytes(32)
        value, pos = int(rng.integers(0, 1 << 63)), int(rng.integers(0, 99))
        assert TS.derive_owner_pk(sk) == JS.derive_owner_pk(sk)
        cm = TS.note_commitment(value, r, pk)
        assert cm == JS.note_commitment(value, r, pk)
        assert TS.note_nullifier(sk, cm, pos) == JS.note_nullifier(sk, cm,
                                                                   pos)


def test_public_inputs_equal_vector(vec):
    circuit = shielded_instance(TS, vec["instance"])
    assert [str(v) for v in public_inputs_of(circuit)] == \
        vec["public_inputs"]


def test_tampered_instance_refused_on_host(vec):
    """prove(check=True) refuses the fee + 1 instance before any device
    work, and check_fits refuses the shielded instance against the L2
    key's shape."""
    pk = ProvingKey.load_npz(L2_KEY)
    bad = shielded_instance(TS, vec["instance"], _fee_plus_one)
    with pytest.raises(ValueError, match="unsatisfied"):
        prove(pk, bad, batch_id=1, device="cpu")
    with pytest.raises(ValueError, match="key / witness mismatch"):
        check_fits(pk, vec["num_instance"],
                   vec["num_instance"] + vec["num_witness"],
                   vec["num_constraints"])


@slow
def test_keygen_and_prove_equal_vector(vec):
    from zelana_tpu_torch.groth16.setup import keygen
    from zelana_tpu_torch.groth16.verify import verify
    from zelana_tpu_torch.sequencer.prover_service import \
        proof_to_solana_bytes

    circuit = shielded_instance(TS, vec["instance"])
    pk = keygen(circuit, seed=0, device="cpu")
    assert hashlib.sha256(pk.serialize_compressed()).hexdigest() == \
        vec["key_sha256"]
    assert pk.vk.serialize_compressed().hex() == vec["vk"]
    proof = prove(pk, circuit, batch_id=vec["instance"]["batch_id"],
                  device="cpu")
    assert proof.serialize_compressed().hex() == vec["proof"]
    assert proof_to_solana_bytes(proof).hex() == vec["proof_bytes"]
    assert verify(pk.vk, proof, [int(v) for v in vec["public_inputs"]])
