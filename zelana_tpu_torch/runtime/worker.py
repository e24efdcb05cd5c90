"""Chunk-proving worker HTTP service + dispatcher-side HTTP client.

Mirror of forge/crates/prover-worker/src/main.rs: a standalone service
that proves one fixed-capacity chunk per request. Where the reference
shells out to nargo+sunspot subprocesses (prover.rs:441-573), this worker
proves the BatchCircuitMiMC chunk on the Groth16 engine directly
(runtime/chunk_prover.py) on the prover's device -- the card replaces the
subprocess plane.

Endpoints:
  GET  /health -> {status, capacity, tree_depth}
  GET  /spans  -> {device, peak_bytes, spans}: the process's span ring
                  (trace.py; each record as a dict) and the prover's device
                  with its torch.cuda.max_memory_allocated (0 on the CPU)
  POST /prove  -> ChunkProveRequest (runtime/messages.py; slot witnesses
                  carried as JSON dicts) -> ProofResult with the
                  388-byte sunspot-shaped proof

A request records `worker.request` around `worker.decode`, the prover's
`chunk.prove` and `worker.encode`, all under the request id
`<batch>/<chunk>`; it ends before the answer is written.

`http_chunk_prover(worker_urls)` returns a Dispatcher-compatible
chunk_prover callable that round-robins chunks across workers over HTTP --
the coordinator's WORKERS-env fan-out (prover-coordinator/main.rs:86-99)
with the same in-process Dispatcher driving it. A chunk records
`coord.dispatch` (`worker`: the index of its URL, `request_bytes`,
`response_bytes`) around `coord.encode`, `coord.http` and `coord.decode`.

The server answers requests on several threads and proves the chunks
they carry at once, as the JAX package's worker does: the proves share one
card and the port's process-wide state (NTT plans, query pools, launch
counts, the native libraries), each built or counted under its own lock,
and their kernels queue on the card's default stream."""

from __future__ import annotations

import dataclasses
import itertools
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List
from urllib import request as urlrequest

from ..circuits.batch_mimc import ShieldedSlot, TransferSlot, WithdrawalSlot
from ..trace import span, spans
from .chunk_prover import Groth16ChunkProver
from .coordinator import Chunk, ChunkProof
from .messages import ChunkProveRequest, ProofResult, fr_from_hex, fr_to_hex


def _slot_to_json(slot) -> dict:
    return dataclasses.asdict(slot)


def _slots_from_json(items: List[dict], cls) -> list:
    return [cls(**d) for d in items]


def chunk_to_request(chunk: Chunk, batch_id: int) -> ChunkProveRequest:
    return ChunkProveRequest(
        batch_id=batch_id,
        chunk_index=chunk.index,
        pre_state_root=fr_to_hex(chunk.pre_state_root),
        post_state_root=fr_to_hex(chunk.post_state_root),
        pre_shielded_root=fr_to_hex(chunk.pre_shielded_root),
        post_shielded_root=fr_to_hex(chunk.post_shielded_root),
        transfers=[_slot_to_json(s) for s in chunk.transfers],
        withdrawals=[_slot_to_json(s) for s in chunk.withdrawals],
        shielded=[_slot_to_json(s) for s in chunk.shielded],
    )


def chunk_from_request(req: ChunkProveRequest) -> Chunk:
    return Chunk(
        index=req.chunk_index,
        transfers=_slots_from_json(req.transfers, TransferSlot),
        withdrawals=_slots_from_json(req.withdrawals, WithdrawalSlot),
        shielded=_slots_from_json(req.shielded, ShieldedSlot),
        pre_state_root=fr_from_hex(req.pre_state_root),
        post_state_root=fr_from_hex(req.post_state_root),
        pre_shielded_root=fr_from_hex(req.pre_shielded_root),
        post_shielded_root=fr_from_hex(req.post_shielded_root),
    )


def start_worker(prover: Groth16ChunkProver, port: int = 0):
    """Boot a chunk-proving worker; returns (server, port)."""

    def peak_bytes() -> int:
        if prover.device.type != "cuda":
            return 0
        import torch

        return torch.cuda.max_memory_allocated(prover.device)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def _send(self, code: int, body: bytes):
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, payload: dict):
            self._send(code, json.dumps(payload).encode())

        def do_GET(self):
            if self.path == "/health":
                return self._json(200, {
                    "status": "ok",
                    "capacity": list(prover.capacity),
                    "tree_depth": prover.tree_depth,
                })
            if self.path == "/spans":
                return self._json(200, {
                    "device": str(prover.device),
                    "peak_bytes": peak_bytes(),
                    "spans": [r._asdict() for r in spans()],
                })
            return self._json(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/prove":
                return self._json(404, {"error": "not found"})
            length = int(self.headers.get("Content-Length", 0))
            with span("worker.request") as top:
                raw = self.rfile.read(length) if length else b""
                try:
                    with span("worker.decode") as decode:
                        req = ChunkProveRequest.from_json(
                            json.loads(raw) if raw else {})
                        chunk = chunk_from_request(req)
                        rid = f"{req.batch_id}/{req.chunk_index}"
                        decode.tag(rid)
                    top.tag(rid)
                    cp = prover.prove_chunk(chunk, req.batch_id)
                    with span("worker.encode"):
                        payload = ProofResult(
                            chunk_index=cp.chunk_index,
                            proof=cp.proof_bytes.hex(),
                            public_inputs=[fr_to_hex(v)
                                           for v in cp.public_inputs],
                            proving_time_ms=cp.proving_time_ms,
                        ).to_json()
                        payload["public_witness"] = cp.public_witness.hex()
                        code, body = 200, json.dumps(payload).encode()
                except Exception as exc:
                    code, body = 500, json.dumps({"error": str(exc)}).encode()
            # the span ends before the answer is written: it lies inside the
            # caller's wait for the answer
            return self._send(code, body)

    server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, server.server_address[1]


def http_chunk_prover(worker_urls: List[str], timeout: float = 600.0):
    """A Dispatcher-compatible chunk_prover that POSTs chunks to workers
    round-robin (the coordinator's cross-HOST axis; within one host the
    worker's own mesh of cards is the device axis)."""
    cycle = itertools.cycle(range(len(worker_urls)))
    lock = threading.Lock()

    def prove(chunk: Chunk, batch_id: int) -> ChunkProof:
        with lock:
            k = next(cycle)
        with span("coord.dispatch", request=f"{batch_id}/{chunk.index}",
                  worker=k) as sp:
            with span("coord.encode"):
                data = json.dumps(chunk_to_request(chunk, batch_id)
                                  .to_json()).encode()
            sp.counts["request_bytes"] = len(data)
            req = urlrequest.Request(
                worker_urls[k] + "/prove", data=data,
                headers={"Content-Type": "application/json"})
            with span("coord.http"):
                with urlrequest.urlopen(req, timeout=timeout) as resp:
                    raw = resp.read()
            sp.counts["response_bytes"] = len(raw)
            with span("coord.decode"):
                payload = json.loads(raw)
                result = ProofResult.from_json(payload)
                return ChunkProof(
                    chunk_index=result.chunk_index,
                    proof_bytes=bytes.fromhex(result.proof),
                    public_inputs=[fr_from_hex(h)
                                   for h in result.public_inputs],
                    proving_time_ms=result.proving_time_ms,
                    public_witness=bytes.fromhex(
                        payload.get("public_witness", "")),
                )

    return prove
