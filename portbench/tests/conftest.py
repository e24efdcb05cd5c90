"""The benchmark's CPU tests: run them from the root of a checkout with
`python -m pytest portbench/tests -q`. Tests marked `card` need a CUDA card
and skip without one (decided inside a fixture)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.cuda.get_device_name(0)


@pytest.fixture
def small_chunk_cell(monkeypatch):
    """The chunk cell at a size a test can hold (capacity 2/0/2, depth 4,
    three-chunk batches), the program's prover replaced by the reference's
    (control.ReferenceChunkProver), run with device "cpu"."""
    from portbench import control
    from portbench import harness as H
    from zelana_tpu_torch.runtime import chunk_prover

    monkeypatch.setattr(chunk_prover, "Groth16ChunkProver",
                        control.ReferenceChunkProver)
    cell = H.find_cell(H.load_json(f"{ROOT}/BENCHMARK.json"),
                       "chunk844_d32.backlog")
    cell.config = dict(cell.config, capacity=[2, 0, 2], tree_depth=4)
    cell.traffic = dict(cell.traffic, chunks=3)
    yield cell
    control.ReferenceChunkProver.fault = None
