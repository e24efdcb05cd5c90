"""The prover network on one host, on the CPU: two chunk worker processes
started by SwarmController (`python -m zelana_tpu_torch.cli --device cpu
worker --pk <key file>`), one key file, and the coordinator alone in a
process of its own (`python -m zelana_tpu_torch.cli coordinator --workers
<urls>`: sequencer/api.start_coordinator's /v2/batch routes over
Dispatcher(http_chunk_prover(urls))).

The key is the dryrun chunk's (capacity 1/0/1, depth 1): the seed-0 keygen
of Groth16ChunkProver.setup((1, 0, 1), 1, 0), committed as
artifacts/chunk_101_d1_pk.npz (chip_smoke.py remakes it on the card and
compares), loaded and written again with ProvingKey.save_npz for the
workers. A keygen on the CPU, even at this size, takes many minutes, and so
does a prove's plain run-scan; so the MSMs' device program returns
identities in the workers (a sitecustomize module on their PYTHONPATH) and
in this process, as tests/test_torch_trace.py stubs it: every other stage
of a chunk prove runs as written.

- A three-chunk job posted as the coordinator takes it: its proofs are
  byte-equal to prove_chunks on the same chunks and batch id, and its
  public inputs equal portbench/reference's.
- The spans of both sides: the coordinator's coord.job, coord.build_chunks,
  coord.dispatch (coord.encode, coord.http, coord.decode) from its
  GET /spans and each worker's worker.request (worker.decode, chunk.prove,
  worker.encode) from its GET /spans, with its device and peak_bytes; the
  request ids match across the processes, and each dispatch's span holds
  its worker's request span on the one clock.
- time.perf_counter is one clock for every process of the host.
- A worker given a missing key file exits at once; a worker and a
  coordinator exit when the process that started them is killed; the
  coordinator alone answers no pipeline route.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import pytest
import torch

from portbench.reference.chunk_batch import SMT, Batch, public_values
from zelana_tpu_torch.groth16.keys import ProvingKey
from zelana_tpu_torch.ops import curve_kernels as CK
from zelana_tpu_torch.ops import msm_scan as MSM
from zelana_tpu_torch.runtime.chunk_prover import Groth16ChunkProver
from zelana_tpu_torch.runtime.chunk_witness import ChunkWitnessBuilder
from zelana_tpu_torch.runtime.control import SwarmController
from zelana_tpu_torch.runtime.coordinator import Dispatcher

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEY_101 = os.path.join(ROOT, "artifacts", "chunk_101_d1_pk.npz")
CAP, DEPTH = (1, 0, 1), 1
BATCH = 7301
SPEC = {"funds": [(1, 100), (2, 0)], "notes": [],
        "transfers": [(1, 2, 10), (2, 1, 5), (1, 2, 3)], "withdrawals": [],
        "shielded": [777, 778, 779]}
STUB = textwrap.dedent('''\
    """Loaded at start-up by the chunk workers of
    tests/test_torch_served_fleet.py: the MSMs' device program returns
    identities, as the test stubs it in its own process."""
    import torch

    from zelana_tpu_torch.ops import curve_kernels as CK
    from zelana_tpu_torch.ops import msm_scan as MSM

    torch.set_num_threads(1)
    MSM._device_msm = lambda pool, d, curve: torch.zeros(
        (CK.rows(curve), 8 * 32), dtype=torch.int32)
''')


def identities(pool, d, curve):
    return torch.zeros((CK.rows(curve), 8 * 32), dtype=torch.int32)


def call(url, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def request_body(batch_id):
    return {"batch_id": batch_id,
            "accounts": [{"pk": str(pk), "balance": str(b)}
                         for pk, b in SPEC["funds"]],
            "transfers": [[str(x) for x in t] for t in SPEC["transfers"]],
            "withdrawals": [],
            "shielded_commitments": [str(c) for c in SPEC["shielded"]],
            "pre_shielded_root": str(SMT(DEPTH).root())}


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """(the coordinator's URL, the workers' URLs, the served job's result
    as fetched, the coordinator's spans since the job was posted, from its
    GET /spans)."""
    tmp = tmp_path_factory.mktemp("fleet")
    key = str(tmp / "chunk_pk.npz")
    ProvingKey.load_npz(KEY_101).save_npz(key)
    (tmp / "sitecustomize.py").write_text(STUB)
    old = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = os.pathsep.join([str(tmp), ROOT])
    ctl = SwarmController(log_dir=str(tmp / "logs"), device="cpu")
    try:
        urls = [s.url for s in ctl.start_workers(
            [("w0", "cpu"), ("w1", "cpu")], capacity="1/0/1", depth=DEPTH,
            timeout=120, pk=key)]
        url = ctl.start_coordinator(urls, capacity="1/0/1",
                                    depth=DEPTH).url
        since = time.perf_counter()
        code, posted = call(url + "/v2/batch/prove", request_body(BATCH))
        assert code == 200, posted
        job = posted["job_id"]
        deadline = time.time() + 120
        while call(f"{url}/v2/batch/{job}/status")[1]["status"] != "done":
            assert time.time() < deadline, ctl.logs("w0") + ctl.logs("w1")
            time.sleep(0.05)
        code, result = call(f"{url}/v2/batch/{job}/proof")
        assert code == 200
        code, got = call(url + "/spans")
        assert code == 200 and set(got) == {"spans"}
        coord = [SimpleNamespace(**r) for r in got["spans"]
                 if r["start"] >= since]
        yield url, urls, result, coord
    finally:
        ctl.stop()
        if old is None:
            os.environ.pop("PYTHONPATH")
        else:
            os.environ["PYTHONPATH"] = old


def test_served_job_equals_prove_chunks_and_reference(fleet, monkeypatch):
    _url, _urls, result, _coord = fleet
    builder = ChunkWitnessBuilder(DEPTH)
    for pk, balance in SPEC["funds"]:
        builder.fund(pk, balance)
    chunks = Dispatcher.build_chunks_with_witness(
        builder, SPEC["transfers"], [], SPEC["shielded"], capacity=CAP,
        pre_shielded_root=SMT(DEPTH).root())
    monkeypatch.setattr(MSM, "_device_msm", identities)
    prover = Groth16ChunkProver(ProvingKey.load_npz(KEY_101), CAP, DEPTH,
                                device="cpu")
    local = prover.prove_chunks(chunks, BATCH)
    served = result["chunks"]
    assert result["batch_id"] == BATCH and len(served) == len(local) == 3
    ref = Batch(SPEC, CAP, DEPTH)
    for k, (s, cp) in enumerate(zip(served, local)):
        assert s["index"] == cp.chunk_index == k
        assert s["proof"] == cp.proof_bytes.hex()
        assert s["public_witness"] == cp.public_witness.hex()
        assert ([int(v) for v in s["public_inputs"]] == cp.public_inputs
                == public_values(ref.chunks[k], BATCH))


def test_spans_match_across_processes(fleet):
    _url, urls, _result, coord = fleet
    requests = {f"{BATCH}/{k}" for k in range(3)}
    (job,) = [r for r in coord if r.name == "coord.job"]
    assert (job.request, job.counts) == (str(BATCH), {"chunks": 3})
    (build,) = [r for r in coord if r.name == "coord.build_chunks"]
    assert build.request == str(BATCH) and build.end <= job.start
    dispatch = {r.request: r for r in coord if r.name == "coord.dispatch"}
    assert set(dispatch) == requests
    ids = {r.id: r for r in coord}
    for r in dispatch.values():
        assert ids[r.parent] is job and r.thread != job.thread
        assert set(r.counts) == {"worker", "request_bytes",
                                 "response_bytes"}
        assert r.counts["request_bytes"] > 0 < r.counts["response_bytes"]
    for leaf in ("coord.encode", "coord.http", "coord.decode"):
        rows = [r for r in coord if r.name == leaf]
        assert sorted(r.request for r in rows) == sorted(requests)
        assert all(ids[r.parent].name == "coord.dispatch" for r in rows)
    seen = set()
    for k, url in enumerate(urls):
        code, got = call(url + "/spans")
        assert code == 200 and (got["device"], got["peak_bytes"]) == (
            "cpu", 0)
        rows = [r for r in got["spans"] if r["request"] in requests]
        mine = {r["request"] for r in rows if r["name"] == "worker.request"}
        assert mine == {q for q, d in dispatch.items()
                        if d.counts["worker"] == k}
        seen |= mine
        wid = {r["id"]: r for r in got["spans"]}
        for q in mine:
            by = {r["name"]: r for r in rows if r["request"] == q}
            assert {"worker.request", "worker.decode", "chunk.prove",
                    "worker.encode"} <= set(by)
            top = by["worker.request"]
            for leaf in ("worker.decode", "chunk.prove", "worker.encode"):
                assert wid[by[leaf]["parent"]] == top
            # one clock: the worker's request lies inside its dispatch
            http = dispatch[q]
            assert http.start < top["start"] <= top["end"] < http.end
    assert seen == requests


def test_perf_counter_is_one_clock_across_processes():
    assert (time.get_clock_info("perf_counter").implementation
            == "clock_gettime(CLOCK_MONOTONIC)")
    t0 = time.perf_counter()
    child = float(subprocess.run(
        [sys.executable, "-c", "import time; print(time.perf_counter())"],
        capture_output=True, text=True, check=True).stdout)
    t1 = time.perf_counter()
    assert t0 < child < t1


def test_coordinator_alone_serves_no_pipeline_route(fleet):
    url = fleet[0]
    assert call(url + "/health") == (200, {"status": "ok"})
    assert call(url + "/status/stats")[0] == 404
    assert call(url + "/transfer", {"from": "00" * 32})[0] == 404
    code, got = call(url + "/v2/batch/prove", {})
    assert code == 400 and "coordinator-shaped" in got["error"]
    assert call(url + "/v2/batch/nope/status")[0] == 404


def test_worker_with_missing_key_exits_at_once(tmp_path):
    ctl = SwarmController(log_dir=str(tmp_path), device="cpu")
    t0 = time.time()
    with pytest.raises(RuntimeError, match="exited with code 1: worker: no "
                                           "key file"):
        ctl.start_worker("w", capacity="1/0/1", depth=1, timeout=120,
                         pk=str(tmp_path / "missing.npz"))
    assert time.time() - t0 < 30 and ctl.status() == {}


def outlives_parent(tmp_path, start: str) -> bool:
    """A process runs `start` (a SwarmController `ctl` at hand; it binds
    `svc`), prints the service's pid and is killed (SIGKILL: no clean-up of
    its own). Whether the service is still running 20 s later (it is then
    killed)."""
    parent = subprocess.Popen([sys.executable, "-c", textwrap.dedent(f"""\
        import sys, time
        sys.path.insert(0, {ROOT!r})
        from zelana_tpu_torch.runtime.control import SwarmController
        ctl = SwarmController(log_dir={str(tmp_path)!r}, device="cpu")
        {start}
        print(svc.process.pid, flush=True)
        time.sleep(120)
        """)], stdout=subprocess.PIPE, text=True)
    try:
        pid = int(parent.stdout.readline())
    finally:
        parent.kill()
        parent.wait()
    deadline = time.time() + 20
    while time.time() < deadline:
        try:
            with open(f"/proc/{pid}/stat") as f:
                if f.read().rsplit(")", 1)[1].split()[0] == "Z":
                    return False  # exited, not yet reaped
        except FileNotFoundError:
            return False
        time.sleep(0.1)
    os.killpg(pid, signal.SIGKILL)
    return True


def test_worker_exits_with_its_parent(tmp_path):
    assert not outlives_parent(
        tmp_path, f"svc = ctl.start_worker('w', capacity='1/0/1', depth=1, "
        f"timeout=120, pk={KEY_101!r})"), "the worker outlived its parent"


def test_coordinator_exits_with_its_parent(tmp_path):
    """The coordinator needs no worker to start; it is given one URL that
    nothing serves."""
    assert not outlives_parent(
        tmp_path, "svc = ctl.start_coordinator(['http://127.0.0.1:9'], "
        "capacity='1/0/1', depth=1)"), "the coordinator outlived its parent"
