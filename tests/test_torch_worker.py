"""The chunk-proving worker plane of the port (zelana_tpu_torch.runtime:
worker.py, messages.py, and the API's chunked /v2/batch/prove over a
Dispatcher) against the JAX package's, on the CPU, with a stub chunk prover
in each package as tests/test_chunk_prover.py's
test_http_worker_plane_round_trip has: the wire layer is what is under
test. The request JSON, the proofs the dispatcher collects over HTTP and the
API's job result are byte-equal to the JAX package's. Two chunks reach one
worker at once, and it proves them at once, in the port as in the JAX
package.

chip_smoke.py's `sequencer` phase serves two production chunks through the
worker with the real prover on the card."""

import json
import threading
import time

import torch

import zelana_tpu.runtime.chunk_prover as JCP
import zelana_tpu.runtime.chunk_witness as JCW
import zelana_tpu.runtime.coordinator as JC
import zelana_tpu.runtime.messages as JM
import zelana_tpu.runtime.worker as JW
import zelana_tpu_torch.runtime.chunk_prover as TCP
import zelana_tpu_torch.runtime.chunk_witness as TCW
import zelana_tpu_torch.runtime.coordinator as TC
import zelana_tpu_torch.runtime.messages as TM
import zelana_tpu_torch.runtime.worker as TW

from test_torch_sequencer import JAX, PORT, http, orchestrator

torch.set_num_threads(1)

CAP = (2, 1, 1)
DEPTH = 4
ACCOUNTS = [(1, 1_000), (2, 500), (5, 300)]
TRANSFERS = [(1, 2, 10), (2, 5, 20), (1, 5, 30), (5, 1, 5), (1, 2, 7),
             (2, 1, 9)]
WITHDRAWALS = [(1, 0xAA, 50), (2, 0xBB, 25)]
SHIELDED = [111, 222]
BATCH_ID = 9


def chunks(cw, coord):
    builder = cw.ChunkWitnessBuilder(DEPTH)
    for pk, balance in ACCOUNTS:
        builder.fund(pk, balance)
    return coord.Dispatcher.build_chunks_with_witness(
        builder, TRANSFERS, WITHDRAWALS, SHIELDED, capacity=CAP,
        pre_shielded_root=7)


def stub_prover(cp, cw, coord, worker, hold=None):
    """The package's Groth16ChunkProver with test_chunk_prover.py's stub
    prove_chunk, which counts the proves running at once. `hold`: an
    event set when two proves run at once; each prove waits for it."""

    class Stub(cp.Groth16ChunkProver):
        def __init__(self):
            kw = {"device": "cpu"} if cp is TCP else {}
            super().__init__(pk=None, capacity=CAP, tree_depth=DEPTH, **kw)
            self.running = self.most = 0
            self.count = threading.Lock()

        def prove_chunk(self, chunk, batch_id):
            with self.count:
                self.running += 1
                self.most = max(self.most, self.running)
                if hold is not None and self.running == 2:
                    hold.set()
            if hold is not None:
                assert hold.wait(10), "the two proves never ran at once"
            wd_root, batch_hash = cw.chunk_accumulators(
                batch_id, chunk.transfers, chunk.withdrawals, chunk.shielded)
            values = [chunk.pre_state_root, chunk.post_state_root,
                      chunk.pre_shielded_root, chunk.post_shielded_root,
                      wd_root, batch_hash, batch_id]
            with self.count:
                self.running -= 1
            return coord.ChunkProof(
                chunk_index=chunk.index,
                proof_bytes=bytes([chunk.index]) * 388,
                public_inputs=values, proving_time_ms=1,
                public_witness=cp.sunspot_public_witness(values))

    return Stub()


def wait_job(dispatcher, job, timeout=20.0):
    deadline = time.time() + timeout
    while dispatcher.status(job) == "running":
        assert time.time() < deadline, "job still running"
        time.sleep(0.01)
    return dispatcher.proofs(job)


def test_requests_match_jax():
    jchunks, tchunks = chunks(JCW, JC), chunks(TCW, TC)
    assert len(tchunks) == 3 and tchunks == [
        TC.Chunk(**{k: getattr(c, k) for k in vars(c)}) for c in tchunks]
    for jc, tc in zip(jchunks, tchunks):
        want = json.dumps(JW.chunk_to_request(jc, BATCH_ID).to_json())
        got = json.dumps(TW.chunk_to_request(tc, BATCH_ID).to_json())
        assert got == want
        back = TW.chunk_from_request(
            TM.ChunkProveRequest.from_json(json.loads(got)))
        assert back == tc
    assert TM.fr_to_hex(2**254 + 5) == JM.fr_to_hex(2**254 + 5)
    assert TM.fr_from_hex(JM.fr_to_hex(12345)) == 12345


def plane(pkg_mods, hold=None):
    """Two workers of one package behind a Dispatcher over HTTP; the
    proofs of one job, and each worker's stub."""
    cp, cw, coord, worker = pkg_mods
    stubs = [stub_prover(cp, cw, coord, worker, hold) for _ in range(2)]
    servers = [worker.start_worker(s) for s in stubs]
    try:
        urls = [f"http://127.0.0.1:{port}" for _, port in servers]
        dispatcher = coord.Dispatcher(
            chunk_prover=worker.http_chunk_prover(urls))
        proofs = wait_job(dispatcher, dispatcher.submit_job(
            chunks(cw, coord), BATCH_ID))
    finally:
        for server, _ in servers:
            server.shutdown()
            server.server_close()
    return proofs, stubs


def test_worker_plane_matches_jax():
    want, _ = plane((JCP, JCW, JC, JW))
    got, _ = plane((TCP, TCW, TC, TW))
    assert [vars(p) for p in got] == [vars(p) for p in want]
    assert [p.chunk_index for p in got] == [0, 1, 2]
    assert got[0].public_inputs[1] == got[1].public_inputs[0]


def served_at_once(cp, cw, coord, worker):
    """Both chunks of a two-chunk job sent to one worker of a package (the
    Dispatcher's pool sends them together); the job's proofs and the
    worker's stub."""
    stub = stub_prover(cp, cw, coord, worker, hold=threading.Event())
    server, port = worker.start_worker(stub)
    try:
        dispatcher = coord.Dispatcher(chunk_prover=worker.http_chunk_prover(
            [f"http://127.0.0.1:{port}"]))
        proofs = wait_job(dispatcher, dispatcher.submit_job(
            chunks(cw, coord)[:2], BATCH_ID))
    finally:
        server.shutdown()
        server.server_close()
    return proofs, stub


def test_worker_proves_chunks_at_once():
    """One worker proves both chunks of a job at once, the port's as the
    JAX package's (no lock around prove_chunk), and the answers are the
    JAX worker's."""
    want, jstub = served_at_once(JCP, JCW, JC, JW)
    got, stub = served_at_once(TCP, TCW, TC, TW)
    assert jstub.most == 2 and stub.most == 2
    assert [vars(p) for p in got] == [vars(p) for p in want]
    assert [p.chunk_index for p in got] == [0, 1]


def api_job(pkg, cp, cw, coord, worker) -> dict:
    """POST /v2/batch/prove through a package's API, whose Dispatcher
    sends the chunks to one worker over HTTP; the job's status answers and
    result."""
    server, wport = worker.start_worker(stub_prover(cp, cw, coord, worker))
    orch = orchestrator(pkg)
    api, port = pkg.api.start_api(
        orch, dispatcher=coord.Dispatcher(worker.http_chunk_prover(
            [f"http://127.0.0.1:{wport}"])),
        chunk_capacity=CAP, chunk_depth=DEPTH)
    try:
        body = {"batch_id": BATCH_ID,
                "accounts": [{"pk": pk, "balance": b} for pk, b in ACCOUNTS],
                "transfers": TRANSFERS, "withdrawals": WITHDRAWALS,
                "shielded_commitments": SHIELDED, "pre_shielded_root": 7}
        code, answer = http(port, "POST", "/v2/batch/prove", body)
        assert code == 200
        job = answer["job_id"]
        deadline = time.time() + 20
        while http(port, "GET", f"/v2/batch/{job}/status")[1][
                "status"] == "running":
            assert time.time() < deadline, "job still running"
            time.sleep(0.01)
        return {"status": http(port, "GET", f"/v2/batch/{job}/status"),
                "proof": http(port, "GET", f"/v2/batch/{job}/proof"),
                "unknown": http(port, "GET", "/v2/batch/nope/proof")}
    finally:
        for s in (api, server):
            s.shutdown()
            s.server_close()


def test_api_chunk_job_matches_jax():
    want = api_job(JAX, JCP, JCW, JC, JW)
    got = api_job(PORT, TCP, TCW, TC, TW)
    assert json.dumps(got) == json.dumps(want)
    assert got["status"] == (200, {"status": "done"})
    result = got["proof"][1]
    assert [c["index"] for c in result["chunks"]] == [0, 1, 2]
    assert result["post_state_root"] != result["pre_state_root"]


def test_worker_health_and_refusals():
    stub = stub_prover(TCP, TCW, TC, TW)
    server, port = TW.start_worker(stub)
    jserver, jport = JW.start_worker(stub_prover(JCP, JCW, JC, JW))
    try:
        for path, body in (("/health", None), ("/nope", None),
                           ("/prove", {"batch_id": 1}), ("/other", {})):
            method = "GET" if body is None else "POST"
            assert http(port, method, path, body) == http(
                jport, method, path, body)
        assert http(port, "GET", "/health") == (200, {
            "status": "ok", "capacity": [2, 1, 1], "tree_depth": 4})
    finally:
        for s in (server, jserver):
            s.shutdown()
            s.server_close()


def test_result_messages_match_jax():
    values = [3, 2**253 + 1, 0]
    jr = JM.ProofResult(chunk_index=1, proof="ab" * 4,
                        public_inputs=[JM.fr_to_hex(v) for v in values],
                        proving_time_ms=5)
    tr = TM.ProofResult.from_json(json.loads(json.dumps(jr.to_json())))
    assert json.dumps(tr.to_json()) == json.dumps(jr.to_json())
    assert [TM.fr_from_hex(h) for h in tr.public_inputs] == values
