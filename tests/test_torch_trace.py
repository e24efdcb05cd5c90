"""The port's spans (zelana_tpu_torch/trace.py) at the stage boundaries of
a chunk prove, on the CPU.

- Groth16ChunkProver.prove_chunks over the dryrun key's two chunks
  (artifacts/chunk_101_d1_pk.npz), then prove_chunk of the first, with the
  MSMs' device program stubbed to return identities: every stage runs as
  written but the plain run-scan, which takes minutes of one core a chunk.
  Each chunk proof's spans are named, nested, threaded and split by
  request as the benchmark's readers expect. Their proofs are not
  compared: the spans' prove paths are held to the JAX package's proofs by
  tests/test_torch_sharded.py (prove_chunks of the dryrun chunk, byte-equal
  to testdata/chunk_101_d1_proof.json) and tests/test_torch_concurrent.py
  (the one-device MSMs and their h worker, on four threads).
- The schedule builds' spans count their segments and the threads that
  built them: one segment on its own thread, and with segments of 2^12
  points several on the schedule pool, whose threads record no span.
- The shared clock with the benchmark's windows, the ring's bound, spans
  of two threads at once.
"""

import concurrent.futures as cf
import os
import sys
import threading
import time

import pytest
import torch

from portbench import harness as H
from zelana_tpu_torch import trace as TT
from zelana_tpu_torch.groth16.keys import ProvingKey
from zelana_tpu_torch.ops import curve_kernels as CK
from zelana_tpu_torch.ops import msm_scan as MSM
from zelana_tpu_torch.runtime import chunk_prover as TCP
from zelana_tpu_torch.runtime import chunk_witness as TCW
from zelana_tpu_torch.runtime import coordinator as TCO

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
KEY_101 = os.path.join(ROOT, "artifacts", "chunk_101_d1_pk.npz")
BATCH = 41

# prove_chunks' spans of each chunk proof on the CPU (msm.upload is made
# only where a copy goes to a card, msm.wait_device only past
# MSM.MAX_INFLIGHT segments; the worker ran the check, the digits and the
# z schedules, so prove.check, prove.z_digits and msm.z_schedules are not)
PIPELINED = {
    "chunk.prove", "chunk.wait_host_stage", "chunk.host_stage",
    "chunk.build_circuit", "chunk.synthesize", "chunk.check",
    "chunk.z_digits", "chunk.z_schedules", "wm.matvec", "wm.upload",
    "prove.synthesized", "prove.witness_map", "prove.queries",
    "msm.dispatch", "msm.launch", "msm.inf_correction", "prove.wait_h",
    "h.stage", "h.fetch", "h.decode", "h.digits", "h.schedules", "msm.end",
    "msm.fetch_finals", "msm.finish_host", "prove.assembly"}
# prove_chunk's: unpipelined, prove_synthesized does it all
UNPIPELINED = {
    "chunk.prove", "chunk.build_circuit", "chunk.synthesize",
    "prove.synthesized", "prove.check", "prove.witness_map", "wm.matvec",
    "wm.upload", "prove.queries", "prove.z_digits", "msm.z_schedules",
    "msm.dispatch", "msm.launch", "msm.inf_correction", "prove.wait_h",
    "h.stage", "h.fetch", "h.decode", "h.digits", "h.schedules", "msm.end",
    "msm.fetch_finals", "msm.finish_host", "prove.assembly"}
HANDED = ("chunk.host_stage", "h.stage")  # handed to a worker thread
# the schedule builds' spans, each counting its segments and the threads
# that built them
SCHEDULES = ("chunk.z_schedules", "msm.z_schedules", "h.schedules")
POOLED_N = 1 << 12  # the dryrun chunk's h: 8 segments of it


def dryrun_chunks(two: bool):
    b = TCW.ChunkWitnessBuilder(1)
    b.fund(1, 100)  # depth-1 SMT: positions pk & 1
    b.fund(2, 0)
    note = b.add_note(spending_key=777, value=9, blinding=42)
    return TCO.Dispatcher.build_chunks_with_witness(
        b, [(1, 2, 10)] + ([(2, 1, 5)] if two else []), [],
        [("full", note, 777, 0xFACE, 9, 7)] + ([777] if two else []),
        capacity=(1, 0, 1), pre_shielded_root=b.shielded_root())


def recorded(fn):
    """fn()'s result and the spans that started while it ran."""
    since = time.perf_counter()
    out = fn()
    return out, [r for r in TT.spans() if r.start >= since]


@pytest.fixture(scope="module")
def prover():
    return TCP.Groth16ChunkProver(ProvingKey.load_npz(KEY_101), (1, 0, 1), 1,
                                  device="cpu")


@pytest.fixture(scope="module")
def stubbed(prover):
    """(prove_chunks' spans of the two chunks, prove_chunk's spans of the
    first), the MSMs' device program returning identities."""
    real = MSM._device_msm
    MSM._device_msm = lambda pool, d, curve: torch.zeros(
        (CK.rows(curve), 8 * 32), dtype=torch.int32)
    try:
        chunks = dryrun_chunks(True)
        _, batch = recorded(
            lambda: prover.prove_chunks(chunks, BATCH))
        _, one = recorded(
            lambda: prover.prove_chunk(chunks[0], BATCH + 1))
    finally:
        MSM._device_msm = real
    return batch, one


@pytest.fixture(scope="module")
def pooled(prover):
    """prove_chunks' spans of one chunk with segments of POOLED_N points,
    so that h and z build several segments on the schedule pool; the MSMs'
    device program stubbed as in `stubbed`."""
    real, chunk_n = MSM._device_msm, MSM.CHUNK_N
    MSM._device_msm = lambda pool, d, curve: torch.zeros(
        (CK.rows(curve), 8 * 32), dtype=torch.int32)
    MSM.CHUNK_N = POOLED_N
    try:
        _, rows = recorded(
            lambda: prover.prove_chunks(dryrun_chunks(False), BATCH + 2))
    finally:
        MSM._device_msm, MSM.CHUNK_N = real, chunk_n
    return rows


def by_request(rows) -> dict:
    out = {}
    for r in rows:
        out.setdefault(r.request, []).append(r)
    return out


def check_tree(rows) -> None:
    """Every span lies inside its parent. The host stage and the h stage
    run on worker threads, handed their parent across threads; every
    other span is on its parent's thread, and a chunk proof's top spans on
    the calling thread. A span's request is its parent's, unless it opens
    a chunk proof's work (chunk.prove, chunk.host_stage)."""
    ids = {r.id: r for r in rows}
    for r in rows:
        p = ids.get(r.parent)
        if p is None:
            assert r.name in ("chunk.batch", "chunk.prove"), r
            assert r.thread == threading.get_ident(), r
            continue
        assert p.start <= r.start and r.end <= p.end, (p, r)
        assert (p.thread != r.thread) is (r.name in HANDED), (p, r)
        if r.name not in ("chunk.prove", "chunk.host_stage"):
            assert r.request == p.request, (p, r)


def test_prove_chunks_spans(stubbed):
    """Both chunk proofs have every stage's span under their own request;
    the host stages hang off the batch, the h stages off their prove."""
    rows, _one = stubbed
    bid = str(BATCH)
    check_tree(rows)
    reqs = by_request(rows)
    assert set(reqs) == {bid, f"{bid}/0", f"{bid}/1"}
    (batch,) = reqs[bid]
    for k in (0, 1):
        mine = reqs[f"{bid}/{k}"]
        assert {r.name for r in mine} == PIPELINED
        (host,) = [r for r in mine if r.name == "chunk.host_stage"]
        assert host.parent == batch.id
        (h,) = [r for r in mine if r.name == "h.stage"]
        (synth,) = [r for r in mine if r.name == "prove.synthesized"]
        assert h.parent == synth.id
        finish = [r for r in mine if r.name == "msm.finish_host"]
        assert [r.counts for r in finish] == [{"segments": 1}] * 5
        (wm,) = [r for r in mine if r.name == "wm.upload"]
        assert wm.counts == {"bytes": 3 * 8 * 4 * 2**15, "pinned": False}
    # chunk 1's host stage ran while chunk 0 was proved
    (host1,) = [r for r in reqs[f"{bid}/1"] if r.name == "chunk.host_stage"]
    (prove0,) = [r for r in reqs[f"{bid}/0"] if r.name == "chunk.prove"]
    assert host1.start < prove0.end


def test_prove_chunk_spans(stubbed):
    """prove_chunk, unpipelined: its stages under one request."""
    _rows, one = stubbed
    check_tree(one)
    assert set(by_request(one)) == {f"{BATCH + 1}/0"}
    assert {r.name for r in one} == UNPIPELINED


def test_span_inside_its_window_unit():
    """A span opened inside a unit of harness.run_window lies within the
    unit's (start, end): the spans and the benchmark share a clock."""
    class Session:
        def run_unit(self):
            with TT.span("test.unit") as sp:
                time.sleep(0.01)
            return [sp.id]

    run = H.run_window(Session(), 0.05)
    got = {r.id: r for r in TT.spans() if r.name == "test.unit"}
    assert run.units
    for start, end, (sid,) in run.units:
        r = got[sid]
        assert start <= r.start < r.end <= end
        assert r.end - r.start >= 0.01


def test_ring_stays_bounded():
    """Past RING records the oldest go: the newest RING stay, in order."""
    first = None
    for k in range(TT.RING + 100):
        with TT.span("test.ring") as sp:
            pass
        first = sp.id if k == 100 else first
    snap = TT.spans()
    assert len(snap) == TT.RING
    assert [r.id for r in snap] == list(range(first, first + TT.RING))


def test_spans_of_threads_at_once():
    """Sixteen threads record at once, switching every microsecond: no
    record is lost, ids are unique, and each thread's leaves carry its
    thread, its parent and its request."""
    start = threading.Barrier(16)

    def work(label):
        with TT.span("test.outer", request=label) as outer:
            start.wait(timeout=60)
            for _ in range(300):
                with TT.span("test.leaf"):
                    pass
        return outer.id, threading.current_thread().name

    since = time.perf_counter()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with cf.ThreadPoolExecutor(16) as ex:
            futures = {f"t{k}": ex.submit(work, f"t{k}") for k in range(16)}
            got = {k: f.result(timeout=120) for k, f in futures.items()}
    finally:
        sys.setswitchinterval(interval)
    rows = [r for r in TT.spans() if r.start >= since]
    assert len(rows) == 16 * 301
    assert len({r.id for r in rows}) == len(rows)
    for label, (outer, name) in got.items():
        mine = [r for r in rows if r.request == label]
        assert len(mine) == 301
        assert {r.thread_name for r in mine} == {name}
        assert all(r.parent == outer for r in mine if r.name == "test.leaf")


def schedule_counts(rows) -> dict:
    """{span name: its counts} of the schedule builds among rows."""
    return {r.name: r.counts for r in rows if r.name in SCHEDULES}


def test_schedule_spans_count_one_segment(stubbed):
    """The dryrun chunk's h and z fit one segment: every schedule build's
    span counts one segment built on its own thread."""
    rows, one = stubbed
    for req, mine in by_request(rows + one).items():
        if "/" in req:
            got = schedule_counts(mine)
            assert len(got) == 2, (req, got)
            assert all(c == {"segments": 1, "workers": 1}
                       for c in got.values()), (req, got)


def test_schedule_spans_count_pool_workers(pooled):
    """Segments of POOLED_N points: h.schedules and chunk.z_schedules count
    every segment and the pool threads that built them, at most one a
    usable core; the pool threads record no span, so the spans and their
    tree are those of one-segment builds (and msm.wait_device, past
    MSM.MAX_INFLIGHT segments)."""
    check_tree(pooled)
    mine = by_request(pooled)[f"{BATCH + 2}/0"]
    assert {r.name for r in mine} == PIPELINED | {"msm.wait_device"}
    (h_stage,) = [r for r in mine if r.name == "h.stage"]
    (host,) = [r for r in mine if r.name == "chunk.host_stage"]
    assert {r.thread for r in pooled} <= {threading.get_ident(),
                                          h_stage.thread, host.thread}
    got = schedule_counts(mine)
    assert set(got) == {"h.schedules", "chunk.z_schedules"}
    assert got["h.schedules"]["segments"] == 8
    assert got["chunk.z_schedules"]["segments"] > 1
    cores = len(os.sched_getaffinity(0))
    for c in got.values():
        assert 1 <= c["workers"] <= min(cores, c["segments"]), got
