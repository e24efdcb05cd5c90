"""The served cell's driver (drivers/coordinator_served.py) on the CPU:
the coordinator's routes (sequencer/api.start_coordinator), its Dispatcher
and the HTTP dispatch run as written, served from this process in place of
the coordinator's own; the chunk workers are in-process HTTP workers
(runtime/worker.start_worker) over a stand-in that returns the reference's
proofs (control.ReferenceChunkProver), no key file is made or read, and
the cell runs at capacity 2/0/2, depth 4, three-chunk jobs. A clean run is correct;
a worker answering with another batch id's proofs, or dropping a chunk,
reads `correct` false. Each new reader on synthetic worker records, with
None where there is nothing sound to read."""

import time
from types import SimpleNamespace

import pytest
import torch

from portbench import control
from portbench import harness as H
from portbench import run as R
from portbench.drivers import coordinator_served as CS

from conftest import ROOT

READERS = ("dispatch_overhead_ms.served", "worker_busy_min_share.served",
           "coord_build_ms.served", "worker_peak_gib.served")


class StandIn(control.ReferenceChunkProver):
    """A worker's prover: the reference's proof of each chunk, under the
    program's `chunk.prove` span. `fault` "other_batch": the proofs of the
    next batch id; `drop`: the chunk index it refuses."""

    drop = None

    def __init__(self, cap, depth, seed, fault=None, drop=None):
        super().__init__(cap, depth, seed)
        self.capacity, self.tree_depth = cap, depth
        self.device = torch.device("cpu")
        self.fault, self.drop = fault, drop

    def prove_chunk(self, chunk, batch_id):
        from zelana_tpu_torch.trace import span

        with span("chunk.prove", request=f"{batch_id}/{chunk.index}"):
            if chunk.index == self.drop:
                raise RuntimeError(f"chunk {chunk.index} dropped")
            return self.prove_chunks([chunk], batch_id)[0]


@pytest.fixture
def served(monkeypatch):
    """(the cell at the tiny shape, a run function taking the workers'
    count, fault and dropped chunk). The key's maker and the worker
    processes' controller are replaced where the driver finds them."""
    from zelana_tpu_torch.groth16 import keys
    from zelana_tpu_torch.runtime import chunk_prover
    from zelana_tpu_torch.runtime import control as TC
    from zelana_tpu_torch.runtime.coordinator import Dispatcher
    from zelana_tpu_torch.runtime.worker import (http_chunk_prover,
                                                 start_worker)
    from zelana_tpu_torch.sequencer.api import start_coordinator

    plan = {}

    class Key:
        def __new__(cls, pk, cap, depth, device):  # worker 0's prover
            return stand_in(cap, depth, device, pk)

        @staticmethod
        def setup(cap, depth, seed, device):
            assert device == "cpu"
            return SimpleNamespace(pk=SimpleNamespace(
                save_npz=lambda path: None))

    def stand_in(cap, depth, device, key):
        assert device == "cpu"
        return StandIn(cap, depth, plan["seed"], plan["fault"],
                       plan["drop"])

    def url(server):
        return SimpleNamespace(
            url=f"http://127.0.0.1:{server.server_address[1]}")

    class Controller:
        """SwarmController's part, over in-process services."""

        def __init__(self, log_dir):
            self.servers = []

        def start_workers(self, workers, capacity, depth, timeout, pk):
            cap = tuple(int(x) for x in capacity.split("/"))
            started = [start_worker(stand_in(cap, depth, device, pk))[0]
                       for _name, device in workers]
            self.servers += started
            return [url(s) for s in started]

        def start_coordinator(self, workers, capacity, depth):
            cap = tuple(int(x) for x in capacity.split("/"))
            server = start_coordinator(
                Dispatcher(http_chunk_prover(workers),
                           max_workers=len(workers)),
                chunk_capacity=cap, chunk_depth=depth)[0]
            self.servers.append(server)
            return url(server)

        def status(self):
            return {}

        def stop(self):
            for s in self.servers:
                s.shutdown()
                s.server_close()
            self.servers = []

    monkeypatch.setattr(chunk_prover, "Groth16ChunkProver", Key)
    monkeypatch.setattr(TC, "SwarmController", Controller)
    monkeypatch.setattr(keys, "ProvingKey", SimpleNamespace(
        load_npz=lambda path: path))
    cell = H.find_cell(H.load_json(f"{ROOT}/BENCHMARK.json"),
                       "chunk844_d32_w4.served")
    cell.config = dict(cell.config, capacity=[2, 0, 2], tree_depth=4,
                       workers=2)
    cell.traffic = dict(cell.traffic, chunks=3)

    def run(s, trace=False, workers=2, fault=None, drop=None):
        plan.update(seed=s, fault=fault, drop=drop)
        cell.config["workers"] = workers
        return R.run_cell(cell, s, 0.3, trace, device="cpu",
                          t_start=time.time())

    return cell, run


def test_served_clean_run(served):
    cell, run = served
    assert cell.chips == 4
    assert [m["name"] for m in cell.end_to_end] == ["chunk_proofs_per_s",
                                                    "setup_s"]
    assert [m["name"] for m in cell.per_layer] == list(READERS)
    out = run(2**31 + 101)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["attempted"] % 6 == 0
    assert out["failed"] == 0
    assert set(out["metrics"]) == {"chunk_proofs_per_s", "setup_s"}


def test_served_traced_reads_the_fleet(served):
    _cell, run = served
    out = run(2**31 + 102, trace=True)
    assert out["correct"]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(m) == set(READERS) - {"worker_peak_gib.served"}  # the CPU
    assert m["dispatch_overhead_ms.served"] > 0
    assert 0 < m["worker_busy_min_share.served"] <= 1
    assert m["coord_build_ms.served"] > 0


@pytest.mark.parametrize("fault,drop,over", [
    ("other_batch", None, {"proofs_differing"}),
    (None, 1, {"missing_proofs"}),
])
def test_served_faults(served, fault, drop, over):
    """One worker: its answers are every job's, so each fault is seen."""
    _cell, run = served
    out = run(2**31 + 103, workers=1, fault=fault, drop=drop)
    assert out["correct"] is False
    assert {n for n, c in out["checks"].items()
            if c["value"] > c["limit"]} == over
    assert out["failed"] > 0


def rec(name, request, start, end, **counts):
    return {"id": 0, "parent": 0, "request": request, "name": name,
            "thread": 1, "thread_name": "t", "start": start, "end": end,
            "counts": counts}


def fake_run(records, window=(10.0, 20.0)):
    session = SimpleNamespace(fleet_records=lambda: records)
    return SimpleNamespace(session=session, window=window)


def readers():
    return {n: H.load_module("metrics", n) for n in READERS}


def test_readers_on_synthetic_records():
    records = {
        "coordinator": [
            rec("coord.build_chunks", "7", 10.0, 10.5),
            rec("coord.build_chunks", "8", 10.0, 10.3),
            rec("coord.build_chunks", "6", 5.0, 5.4),  # before the window
            rec("coord.dispatch", "7/0", 11.0, 15.0, worker=0),
            rec("coord.dispatch", "7/1", 11.0, 14.0, worker=1),
            rec("coord.dispatch", "8/0", 11.0, 19.0, worker=0),  # no prove
        ],
        "workers": [
            {"device": "cuda:0", "peak_bytes": 2 * 2**30, "spans": [
                rec("chunk.prove", "7/0", 12.0, 14.5),
                rec("chunk.prove", "5/0", 8.0, 12.0)]},  # clipped
            {"device": "cuda:1", "peak_bytes": 3 * 2**30, "spans": [
                rec("chunk.prove", "7/1", 11.5, 13.5)]},
        ]}
    r = readers()
    got = {n: mod.read(fake_run(records)) for n, mod in r.items()}
    assert got["dispatch_overhead_ms.served"] == pytest.approx(
        1e3 * ((4.0 - 2.5) + (3.0 - 2.0)) / 2)
    assert got["worker_busy_min_share.served"] == pytest.approx(0.2)
    assert got["coord_build_ms.served"] == pytest.approx(400.0)
    assert got["worker_peak_gib.served"] == pytest.approx(3.0)


@pytest.mark.parametrize("records", [
    None,
    {"coordinator": [], "workers": []},
    {"coordinator": [rec("coord.dispatch", "7/0", 1.0, 2.0),
                     rec("coord.build_chunks", "7", 1.0, 2.0)],
     "workers": [{"device": "cpu", "peak_bytes": 0, "spans": [
         rec("chunk.prove", "7/0", 1.0, 1.5)]}]},
])
def test_readers_none_without_sound_records(records):
    """No fleet records, no workers, or nothing in the window (and a peak
    of 0 on the CPU): None, not 0. A session without fleet_records (the
    other drivers') gives None too."""
    for name, mod in readers().items():
        run = fake_run(records)
        if records is None:
            run.session = SimpleNamespace()
        got = mod.read(run)
        if name == "worker_busy_min_share.served" and records and \
                records["workers"]:
            assert got == 0.0  # a worker with no prove in the window
        else:
            assert got is None, name


def test_most_at_once():
    rows = [rec("chunk.prove", "1/0", 0.0, 2.0),
            rec("chunk.prove", "1/1", 1.0, 3.0),
            rec("chunk.prove", "1/2", 3.0, 4.0)]
    assert CS.most_at_once(rows) == 2
    assert CS.most_at_once(rows[2:]) == 1 and CS.most_at_once([]) == 0


def test_served_spec_is_commitments_only():
    import random

    from portbench.reference.chunk_batch import Batch

    spec = CS.served_spec((8, 4, 4), 5, random.Random(5), {
        "fund": [5000, 20000], "transfer_amount": [1, 100],
        "withdrawal_amount": [1, 100], "note_value": [1, 1000]}, 32)
    assert spec["notes"] == [] and len(spec["shielded"]) == 18
    assert all(isinstance(c, int) for c in spec["shielded"])
    body = CS.request_body(spec, 9, 0)
    assert body["batch_id"] == 9 and len(body["accounts"]) == 15
    ref = Batch(spec, (8, 4, 4), 32)
    assert [c["counts"] for c in ref.chunks] == [(8, 4, 4)] * 4 + [(4, 2, 2)]
    assert CS.worker_devices("cpu", 3) == ["cpu"] * 3
