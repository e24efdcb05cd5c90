"""Sequencer HTTP API.

Route surface mirrors core/src/api/routes.rs (:14-66): health, account and
balance queries, transfer submission, shielded submit/delegated/merkle-path/
scan, withdrawals, batch/tx status, dev-mode deposit/seal, pipeline stats
and operator pause/resume, plus the prover-coordinator-shaped
/v2/batch/prove job API (forge core_api.rs:374-380) so external sequencers
can drive this framework as a drop-in proving service.

Implementation: stdlib ThreadingHTTPServer + JSON; no external web
framework required.
"""

from __future__ import annotations

import json
import threading
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional
from urllib.parse import urlparse

from .pipeline import PipelineOrchestrator, tx_hash
from .transactions import Deposit, Shielded, Transfer, Withdraw


def _pipeline_tx_hash(tx) -> str:
    return tx_hash(tx).hex()


def _hex(b: bytes) -> str:
    return b.hex()


def _unhex(s: str, n: int = 32) -> bytes:
    b = bytes.fromhex(s)
    assert len(b) == n, f"expected {n} bytes"
    return b


class ApiState:
    def __init__(self, orchestrator: PipelineOrchestrator, dispatcher=None,
                 chunk_capacity=(8, 4, 4), chunk_depth: int = 32):
        self.orch = orchestrator
        self.prove_jobs: Dict[str, dict] = {}
        # distributed chunk-proving plane (runtime/coordinator.Dispatcher
        # with a real chunk prover); None = pipeline-only prove jobs
        self.dispatcher = dispatcher
        self.chunk_capacity = chunk_capacity
        self.chunk_depth = chunk_depth
        # synchronous delegated-ownership prover (ownership_api.rs);
        # None = route disabled
        self.ownership_prover = None


def create_handler(state: ApiState):
    orch = state.orch

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def _json(self, code: int, payload):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _body(self) -> dict:
            length = int(self.headers.get("Content-Length", 0))
            if not length:
                return {}
            return json.loads(self.rfile.read(length))

        def _sse_status(self, job_id: str):
            """SSE status stream (core_api.rs:374-380's SSE leg): emits a
            `status` event on every change until the job is terminal."""
            import time as _time

            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()
            last = None
            deadline = _time.time() + 300.0
            while _time.time() < deadline:
                job = state.prove_jobs.get(job_id)
                status = job["status"] if job else "unknown"
                if status != last:
                    payload = json.dumps({"status": status})
                    self.wfile.write(
                        f"event: status\ndata: {payload}\n\n".encode())
                    self.wfile.flush()
                    last = status
                if status in ("done", "unknown") or status.startswith(
                        "failed"):
                    return
                _time.sleep(0.05)

        # -- GET routes ---------------------------------------------------

        def do_GET(self):
            path = urlparse(self.path).path
            parts = [p for p in path.split("/") if p]
            try:
                if path == "/health":
                    return self._json(200, {"status": "ok"})
                if path == "/status/stats":
                    s = orch.stats
                    b = orch.batches.stats
                    return self._json(200, {
                        "submitted": s.submitted,
                        "batches_proved": s.batches_proved,
                        "batches_settled": s.batches_settled,
                        "proving_time_ms_total": s.proving_time_ms_total,
                        "paused": s.paused,
                        "accepted": b.accepted,
                        "rejected": b.rejected,
                        "sealed_batches": b.sealed_batches,
                        "finalized_batches": b.finalized_batches,
                    })
                if path == "/status/roots":
                    return self._json(200, {
                        "state_root": _hex(orch.tree.root()),
                        "shielded_root": _hex(orch.shielded.root()),
                    })
                if path == "/status/batch":
                    cur = orch.batches.current
                    return self._json(200, {
                        "current_batch_id": cur.id if cur else None,
                        "current_txs": len(cur.transactions) if cur else 0,
                        "sealed": [
                            {"id": b.id, "state": b.state.value,
                             "txs": len(b.transactions)}
                            for b in orch.batches.sealed
                        ],
                    })
                if len(parts) == 2 and parts[0] == "account":
                    acct = orch.get_account(_unhex(parts[1]))
                    return self._json(200, {
                        "balance": acct.balance, "nonce": acct.nonce,
                    })
                if len(parts) == 3 and parts[0] == "shielded" and parts[1] == "merkle_path":
                    pos = int(parts[2])
                    mp = orch.shielded.tree.path(pos)
                    if mp is None:
                        return self._json(404, {"error": "unknown position"})
                    return self._json(200, {
                        "siblings": [_hex(s) for s in mp.siblings],
                        "path_bits": [int(b) for b in mp.path_bits],
                        "position": mp.position,
                        "root": _hex(orch.shielded.root()),
                    })
                if path == "/shielded/root":
                    return self._json(200, {"root": _hex(orch.shielded.root())})
                if path == "/encrypted/committee":
                    if orch.committee is None:
                        return self._json(404, {"error": "no committee"})
                    return self._json(200, {
                        "threshold": orch.committee.threshold,
                        "members": [
                            {"index": m.index, "x25519_pk": _hex(m.x25519_pk)}
                            for m in orch.committee.members
                        ],
                    })
                if (len(parts) == 4 and parts[0] == "v2"
                        and parts[1] == "batch" and parts[3] == "status"):
                    job = state.prove_jobs.get(parts[2])
                    if job is None:
                        return self._json(404, {"error": "unknown job"})
                    query = urlparse(self.path).query
                    if ("stream" in query
                            or "text/event-stream" in
                            (self.headers.get("Accept") or "")):
                        return self._sse_status(parts[2])
                    return self._json(200, {"status": job["status"]})
                if (len(parts) == 4 and parts[0] == "v2"
                        and parts[1] == "batch" and parts[3] == "proof"):
                    job = state.prove_jobs.get(parts[2])
                    if job is None or job["status"] != "done":
                        return self._json(404, {"error": "not ready"})
                    return self._json(200, job["result"])
                return self._json(404, {"error": "not found"})
            except Exception as exc:
                return self._json(400, {"error": str(exc)})

        # -- POST routes --------------------------------------------------

        def do_POST(self):
            path = urlparse(self.path).path
            try:
                body = self._body()
                if path == "/transfer":
                    tx = Transfer(
                        signer_pubkey=_unhex(body["from"]),
                        to=_unhex(body["to"]),
                        amount=int(body["amount"]),
                        nonce=int(body["nonce"]),
                        signature=bytes.fromhex(body.get("signature", "")),
                    )
                    res = orch.submit(tx)
                    code = 200 if res.accepted else 400
                    return self._json(code, {
                        "accepted": res.accepted, "error": res.error,
                        "tx_hash": _pipeline_tx_hash(tx) if res.accepted else None,
                    })
                if path == "/withdraw":
                    tx = Withdraw(
                        from_=_unhex(body["from"]),
                        to_l1_address=_unhex(body["to_l1_address"]),
                        amount=int(body["amount"]),
                        nonce=int(body["nonce"]),
                        signature=bytes.fromhex(body.get("signature", "")),
                    )
                    res = orch.submit(tx)
                    return self._json(200 if res.accepted else 400, {
                        "accepted": res.accepted, "error": res.error,
                        "tx_hash": _pipeline_tx_hash(tx) if res.accepted else None,
                    })
                if path == "/v2/ownership/prove":
                    # synchronous delegated proving (ownership_api.rs:1-45)
                    if state.ownership_prover is None:
                        return self._json(503, {
                            "error": "ownership prover not configured"})
                    try:
                        result = state.ownership_prover.prove(
                            int(body["spending_key"]),
                            int(body["value"]),
                            int(body["blinding"]),
                            int(body["position"]),
                            expected_commitment=body.get("commitment"),
                            expected_nullifier=body.get("nullifier"),
                            expected_proxy=body.get("blinded_proxy"),
                        )
                    except ValueError as exc:
                        return self._json(400, {"error": str(exc)})
                    return self._json(200, result)
                if path in ("/shielded/submit", "/shielded/delegated"):
                    proof_bytes = bytes.fromhex(body.get("proof", ""))
                    if (path == "/shielded/delegated"
                            and state.ownership_prover is not None
                            and body.get("ownership_public_inputs")):
                        # real verification of the delegated ownership proof
                        # (closes the reference's handlers.rs:352-353 TODO)
                        pub = [int(v) for v in
                               body["ownership_public_inputs"]]
                        if not state.ownership_prover.verify(proof_bytes,
                                                             pub):
                            return self._json(400, {
                                "accepted": False,
                                "error": "ownership proof invalid",
                            })
                    tx = Shielded(
                        proof=proof_bytes,
                        nullifier=_unhex(body["nullifier"]),
                        commitment=_unhex(body["commitment"]),
                        ciphertext=bytes.fromhex(body.get("ciphertext", "")),
                        merkle_root=bytes.fromhex(body.get("merkle_root", ""))
                        if body.get("merkle_root") else b"",
                    )
                    res = orch.submit(tx)
                    return self._json(200 if res.accepted else 400, {
                        "accepted": res.accepted, "error": res.error,
                    })
                if path == "/account":
                    aid = _unhex(body["account_id"])
                    acct = orch.get_account(aid)
                    resp = {"balance": acct.balance, "nonce": acct.nonce}
                    pending = orch.get_pending_account(aid)
                    if pending is not None:
                        if pending.balance != acct.balance:
                            resp["pending_balance"] = pending.balance
                        if pending.nonce != acct.nonce:
                            resp["pending_nonce"] = pending.nonce
                    return self._json(200, resp)
                if path == "/shielded/merkle_path":
                    mp = orch.shielded.tree.path(int(body["position"]))
                    if mp is None:
                        return self._json(404, {"error": "unknown position"})
                    return self._json(200, {
                        "siblings": [_hex(s) for s in mp.siblings],
                        "path_bits": [int(b) for b in mp.path_bits],
                        "position": mp.position,
                        "root": _hex(orch.shielded.root()),
                    })
                if path == "/shielded/scan":
                    start = int(body.get("from_position", 0))
                    limit = int(body.get("limit", 1000))
                    notes = []
                    for key, value in orch.store.scan("encrypted_notes"):
                        pos = int.from_bytes(key, "little")
                        if pos < start:
                            continue
                        notes.append({
                            "position": pos,
                            "commitment": _hex(value[:32]),
                            "ciphertext": _hex(value[32:]),
                        })
                        if len(notes) >= limit:
                            break
                    return self._json(200, {
                        "notes": notes,
                        "tree_size": orch.shielded.tree.next_index,
                    })
                if path == "/withdraw/status":
                    h = _unhex(body["tx_hash"])
                    wd_id = orch._wd_by_hash.get(h)
                    if wd_id is None:
                        return self._json(404, {"error": "unknown withdrawal"})
                    wd = orch.withdrawals.items[wd_id]
                    return self._json(200, {
                        "state": wd.state.value,
                        "batch_id": wd.batch_id,
                        "l1_signature": wd.l1_signature,
                        "amount": wd.amount,
                    })
                if path == "/withdraw/fast/quote":
                    amount = int(body["amount"])
                    fw = orch.fast_withdrawals
                    available = fw.can_front(amount)
                    return self._json(200, {
                        "available": available,
                        "amount": amount,
                        "fee": amount - fw.quote(amount),
                        "amount_received": fw.quote(amount),
                        "fee_bps": fw.config.fee_bps,
                    })
                if path == "/withdraw/fast/execute":
                    tx = Withdraw(
                        from_=_unhex(body["from"]),
                        to_l1_address=_unhex(body["to_l1_address"]),
                        amount=int(body["amount"]),
                        nonce=int(body["nonce"]),
                        signature=bytes.fromhex(body.get("signature", "")),
                    )
                    received, err = orch.execute_fast_withdraw(tx)
                    if err is not None:
                        return self._json(400, {"accepted": False, "error": err})
                    return self._json(200, {
                        "accepted": True, "amount_received": received,
                    })
                if path == "/withdraw/fast/register_lp":
                    orch.fast_withdrawals.add_liquidity(
                        _unhex(body["lp"]), int(body["amount"])
                    )
                    return self._json(200, {
                        "total_liquidity": orch.fast_withdrawals.total_liquidity(),
                    })
                if path == "/encrypted/submit":
                    from ..sdk.threshold import EncryptedTx

                    etx = EncryptedTx(
                        tx_id=bytes.fromhex(body["tx_id"]),
                        ciphertext=bytes.fromhex(body["ciphertext"]),
                        encrypted_shares={
                            int(k): bytes.fromhex(v)
                            for k, v in body["encrypted_shares"].items()
                        },
                    )
                    orch.submit_encrypted(etx)
                    return self._json(200, {"tx_id": body["tx_id"]})
                if path == "/batch":
                    record = orch.get_batch_record(int(body["batch_id"]))
                    if record is None:
                        return self._json(404, {"error": "unknown batch"})
                    return self._json(200, record)
                if path == "/batches":
                    return self._json(200, {
                        "batches": orch.list_batch_records(
                            int(body.get("limit", 100))
                        ),
                    })
                if path == "/tx":
                    record = orch.get_tx(_unhex(body["tx_hash"]))
                    if record is None:
                        return self._json(404, {"error": "unknown tx"})
                    return self._json(200, record)
                if path == "/txs":
                    return self._json(200, {
                        "txs": orch.list_txs(int(body.get("limit", 100))),
                    })
                if path == "/dev/deposit":
                    tx = Deposit(
                        to=_unhex(body["to"]),
                        amount=int(body["amount"]),
                        l1_seq=int(body.get("l1_seq", 0)),
                    )
                    res = orch.submit(tx)
                    return self._json(200, {"accepted": res.accepted})
                if path == "/dev/seal":
                    batch = orch.seal()
                    return self._json(200, {
                        "sealed": batch.id if batch else None,
                    })
                if path == "/admin/pause":
                    orch.pause()
                    return self._json(200, {"paused": True})
                if path == "/admin/resume":
                    orch.resume()
                    return self._json(200, {"paused": False})
                if path == "/v2/batch/prove" and state.dispatcher is not None \
                        and "transfers" in body:
                    # coordinator-shaped request (CoreBatchProveRequest,
                    # core_api.rs:40-58): raw txs + initial accounts; the
                    # server builds chunk witnesses with intermediate SMT
                    # paths, chains roots, and dispatches REAL chunk proofs
                    from ..runtime.chunk_witness import ChunkWitnessBuilder
                    from ..runtime.coordinator import Dispatcher

                    builder = ChunkWitnessBuilder(state.chunk_depth)
                    for acct in body.get("accounts", []):
                        builder.fund(int(acct["pk"]), int(acct["balance"]),
                                     int(acct.get("nonce", 0)))
                    chunks = Dispatcher.build_chunks_with_witness(
                        builder,
                        [tuple(int(x) for x in t)
                         for t in body.get("transfers", [])],
                        [tuple(int(x) for x in w)
                         for w in body.get("withdrawals", [])],
                        [int(c) for c in body.get("shielded_commitments",
                                                  [])],
                        capacity=state.chunk_capacity,
                        pre_shielded_root=int(
                            body.get("pre_shielded_root", 0)),
                    )
                    batch_id = int(body.get("batch_id", 1))
                    job_id = state.dispatcher.submit_job(chunks, batch_id)
                    state.prove_jobs[job_id] = {"status": "running",
                                                "result": None}

                    def watch(job_id=job_id, chunks=chunks):
                        import time as _time

                        while True:
                            st = state.dispatcher.status(job_id)
                            if st == "done":
                                proofs = state.dispatcher.proofs(job_id)
                                state.prove_jobs[job_id] = {
                                    "status": "done",
                                    "result": {
                                        "batch_id": batch_id,
                                        "pre_state_root": chunks[0].pre_state_root,
                                        "post_state_root": chunks[-1].post_state_root,
                                        "chunks": [
                                            {
                                                "index": p.chunk_index,
                                                "proof": p.proof_bytes.hex(),
                                                "public_witness":
                                                    p.public_witness.hex(),
                                                "public_inputs": [
                                                    str(v) for v in
                                                    p.public_inputs
                                                ],
                                                "proving_time_ms":
                                                    p.proving_time_ms,
                                            }
                                            for p in proofs
                                        ],
                                    },
                                }
                                return
                            if st in ("failed", "cancelled", None):
                                job = state.dispatcher.jobs.get(job_id)
                                err = job.error if job else "unknown"
                                state.prove_jobs[job_id] = {
                                    "status": f"failed: {err}",
                                    "result": None,
                                }
                                return
                            _time.sleep(0.05)

                    threading.Thread(target=watch, daemon=True).start()
                    return self._json(200, {"job_id": job_id})
                if path == "/v2/batch/prove":
                    job_id = uuid.uuid4().hex[:16]
                    state.prove_jobs[job_id] = {"status": "running",
                                                "result": None}

                    def run_job(body=body, job_id=job_id):
                        import time as _time

                        try:
                            orch.seal()
                            # the prove stage runs on a worker thread now:
                            # tick + wait until the proof lands
                            deadline = _time.time() + 300.0
                            while _time.time() < deadline:
                                orch.tick()
                                if not (orch.proving_in_flight
                                        or orch.batches.next_for_proving()):
                                    break
                                _time.sleep(0.02)
                            last = None
                            for b in orch.batches.sealed:
                                if b.proof is not None:
                                    last = b
                            state.prove_jobs[job_id] = {
                                "status": "done",
                                "result": {
                                    "proof": last.proof.proof_bytes.hex()
                                    if last else None,
                                    "batch_id": last.id if last else None,
                                },
                            }
                        except Exception as exc:
                            state.prove_jobs[job_id] = {
                                "status": f"failed: {exc}", "result": None,
                            }

                    threading.Thread(target=run_job, daemon=True).start()
                    return self._json(200, {"job_id": job_id})
                return self._json(404, {"error": "not found"})
            except Exception as exc:
                return self._json(400, {"error": str(exc)})

    return Handler


def start_api(orchestrator: PipelineOrchestrator, port: int = 0,
              dispatcher=None, chunk_capacity=(8, 4, 4),
              chunk_depth: int = 32, ownership_prover=None):
    """Returns (server, actual_port); serve_forever runs on a daemon thread.

    Pass a runtime.coordinator.Dispatcher (with a real chunk prover) to
    enable the coordinator-shaped chunked /v2/batch/prove flow, and a
    runtime.ownership_api.OwnershipProver for /v2/ownership/prove."""
    state = ApiState(orchestrator, dispatcher=dispatcher,
                     chunk_capacity=chunk_capacity, chunk_depth=chunk_depth)
    state.ownership_prover = ownership_prover
    server = ThreadingHTTPServer(("127.0.0.1", port), create_handler(state))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, server.server_address[1]
