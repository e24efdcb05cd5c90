"""The two_at_once cell's driver with the timed path broken underneath:
the program's prover replaced by the reference's stand-in
(control.ReferenceChunkProver), given the prove_chunk the driver calls,
with one fault planted each time. A clean run is correct and proves each
job's two chunks at once; each fault reads `correct` false. The cell runs
at a size a test can hold (capacity 2/0/2, depth 4, device "cpu")."""

import dataclasses
import threading
import time

import pytest

from portbench import control
from portbench import harness as H
from portbench import run as R

from conftest import ROOT


class ChunkAtATime(control.ReferenceChunkProver):
    """The stand-in with prove_chunk. The two calls of a job must meet (a
    barrier), so a driver proving one chunk after the other fails. Fault
    "half_batch": each job's chunk 1 comes back under chunk 0's index, so
    the job's chunk 1 is missing."""

    meet = None

    def prove_chunk(self, chunk, batch_id):
        self.meet.wait(timeout=60)
        if self.fault != "half_batch":
            return self.prove_chunks([chunk], batch_id)[0]
        clean = control.ReferenceChunkProver(self.cap, self.depth, self.seed)
        clean.fault, clean.key = None, self.key
        cp = clean.prove_chunks([chunk], batch_id)[0]
        return dataclasses.replace(cp, chunk_index=0)


@pytest.fixture
def cell(monkeypatch):
    from zelana_tpu_torch.runtime import chunk_prover

    monkeypatch.setattr(ChunkAtATime, "meet", threading.Barrier(2))
    monkeypatch.setattr(chunk_prover, "Groth16ChunkProver", ChunkAtATime)
    c = H.find_cell(H.load_json(f"{ROOT}/BENCHMARK.json"),
                    "chunk844_d32.two_at_once")
    c.config = dict(c.config, capacity=[2, 0, 2], tree_depth=4)
    yield c
    ChunkAtATime.fault = None


@pytest.mark.parametrize("fault,over", [
    (None, set()),
    ("half_batch", {"missing_proofs", "public_inputs_differing"}),
    ("proof_byte", {"proofs_differing"}),
    ("public_input", {"public_inputs_differing"}),
    ("other_batch", {"proofs_differing"}),
])
def test_two_at_once_faults(cell, fault, over):
    ChunkAtATime.fault = fault
    out = R.run_cell(cell, 2**31 + 91, 0.3, False, device="cpu",
                     t_start=time.time())
    assert out["correct"] is (fault is None)
    assert out["attempted"] > 0 and out["attempted"] % 2 == 0
    assert {n for n, c in out["checks"].items()
            if c["value"] > c["limit"]} == over
    assert set(out["metrics"]) == {"chunk_proofs_per_s", "setup_s"}


def test_two_at_once_traced(cell):
    """Traced on the CPU under the stand-in: correct, and no reader finds
    anything (no program span, no profiler window)."""
    out = R.run_cell(cell, 2**31 + 92, 0.3, True, device="cpu",
                     t_start=time.time())
    assert out["correct"] and out["metrics"] == {}
