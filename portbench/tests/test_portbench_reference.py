"""The reference against a proof the JAX package recorded (the port's CPU
tests hold the port to the same vector): the dryrun chunk's proof, byte
for byte; and the reference's chunks against the program's."""

import json
import os

import pytest

from portbench.reference import groth16 as RG
from portbench.reference.chunk_batch import Batch, circuit_input
from portbench.reference.circuits import chunk_circuit
from portbench.reference.cs import ConstraintSystem

from conftest import ROOT

DATA = os.path.join(ROOT, "zelana_tpu_torch", "testdata")


def load(name):
    with open(os.path.join(DATA, name)) as f:
        return json.load(f)


def test_chunk_dryrun_proof():
    vec = load("chunk_101_d1_proof.json")
    spec = {"funds": [(1, 100), (2, 0)], "notes": [(777, 9, 42)],
            "transfers": [(1, 2, 10)], "withdrawals": [],
            "shielded": [["full", 0, 777, 0xFACE, 9, 7]]}
    ch = circuit_input(Batch(spec, (1, 0, 1), 1).chunks[0], vec["batch_id"])
    assert [str(v) for v in ch["public"]] == vec["public_inputs"]
    cs = ConstraintSystem()
    chunk_circuit(cs, ch)
    assert cs.first_bad is None
    key = RG.Key(0, cs.num_constraints + len(cs.inputs))
    got = RG.solana_bytes(RG.proof_points(key, cs, vec["batch_id"]))
    assert (got + bytes(132)).hex() == vec["proof_bytes"]


@pytest.mark.parametrize("depth", [4, 8])
def test_batch_equals_program_chunks(depth):
    """The reference's replay of a seeded batch gives the program's
    coordinator chunks, slot for slot and root for root."""
    import random

    from portbench import frozen
    from portbench.drivers.chunk_backlog import program_chunks
    from portbench.control import ref_chunk

    cap = (2, 1, 2)
    draw = {"fund": [5000, 20000], "transfer_amount": [1, 100],
            "withdrawal_amount": [1, 100], "note_value": [1, 1000]}
    spec = frozen.production_spec(cap, 3, random.Random(depth), draw, depth)
    ours = Batch(spec, cap, depth).chunks
    theirs = [ref_chunk(c, cap, depth) for c in
              program_chunks(spec, cap, depth)]
    assert len(ours) == len(theirs) == 3
    for a, b in zip(ours, theirs):
        assert a == b


def test_unsatisfied_witness_refused():
    """A slot that does not satisfy its circuit is caught as it is
    synthesized, and no proof is made of it."""
    spec = {"funds": [(1, 100), (2, 0)], "notes": [(777, 9, 42)],
            "transfers": [(1, 2, 10)], "withdrawals": [],
            "shielded": [["full", 0, 777, 0xFACE, 9, 7]]}
    ch = circuit_input(Batch(spec, (1, 0, 1), 1).chunks[0], 3)
    ch["transfers"][0] = dict(ch["transfers"][0], amount=11)
    cs = ConstraintSystem()
    chunk_circuit(cs, ch)
    assert cs.first_bad is not None
    with pytest.raises(ValueError):
        RG.proof_scalars(RG.Key(0, cs.num_constraints + len(cs.inputs)),
                         cs, 3)
