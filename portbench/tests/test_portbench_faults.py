"""A run of the cell with the timed path broken underneath: the program's
prover replaced by one that returns the reference's proofs, with one fault
planted each time. A clean run is correct; each fault the cell can have
makes it not correct: half of the batch left out, an answer altered where
it is produced (a proof byte, a public input, a proof of another batch
id's randomness), and a proof altered at one position of the pipeline
only, whichever it is. The harness's look for a card is skipped (device
"cpu"); the cell runs at a size a test can hold (conftest
small_chunk_cell)."""

import random
import time

import pytest

from portbench import control
from portbench import run as R
from portbench.drivers.chunk_backlog import sample_outputs


def run(cell, seed, trace=False):
    return R.run_cell(cell, seed, 0.3, trace, device="cpu",
                      t_start=time.time())


@pytest.mark.parametrize("fault,number", [
    (None, None),
    ("half_batch", "missing_proofs"),
    ("proof_byte", "proofs_differing"),
    ("public_input", "public_inputs_differing"),
    ("other_batch", "proofs_differing"),
])
def test_chunk_faults(small_chunk_cell, fault, number):
    control.ReferenceChunkProver.fault = fault
    out = run(small_chunk_cell, 2**31 + 77)
    assert out["correct"] is (fault is None)
    assert list(out)[-1] == "checks"
    for name, c in out["checks"].items():
        assert (c["value"] > c["limit"]) is (name == number)


@pytest.mark.parametrize("index", [0, 1, 2])
def test_one_position_altered(small_chunk_cell, monkeypatch, index):
    """Every batch's proof of one chunk index has a byte flipped: the
    comparison re-derives a proof of every index, so it is caught."""
    real = control.ReferenceChunkProver.prove_chunks

    def prove_chunks(self, chunks, batch_id):
        out = real(self, chunks, batch_id)
        for cp in out:  # the set-up's warm-up proves one chunk
            if cp.chunk_index == index:
                cp.proof_bytes = bytes([cp.proof_bytes[5] ^ 4]).join(
                    [cp.proof_bytes[:5], cp.proof_bytes[6:]])
        return out

    monkeypatch.setattr(control.ReferenceChunkProver, "prove_chunks",
                        prove_chunks)
    out = run(small_chunk_cell, 2**31 + 79)
    assert out["correct"] is False
    assert out["checks"]["proofs_differing"]["value"] == 1


def test_sample_takes_every_chunk_index():
    class CP:
        def __init__(self, index):
            self.chunk_index = index

    outputs = [(bid, CP(k)) for bid in (1, 2, 3) for k in range(5)]
    for seed in range(20):
        pick = sample_outputs(outputs, 5, random.Random(seed))
        assert sorted(outputs[i][1].chunk_index for i in pick) == \
            list(range(5))
