"""Chunk-proving worker HTTP service + dispatcher-side HTTP client.

Mirror of forge/crates/prover-worker/src/main.rs: a standalone service
that proves one fixed-capacity chunk per request. Where the reference
shells out to nargo+sunspot subprocesses (prover.rs:441-573), this worker
proves the BatchCircuitMiMC chunk on the Groth16 engine directly
(runtime/chunk_prover.py) on the prover's device -- the card replaces the
subprocess plane.

Endpoints:
  GET  /health -> {status, capacity, tree_depth}
  POST /prove  -> ChunkProveRequest (runtime/messages.py; slot witnesses
                  carried as JSON dicts) -> ProofResult with the
                  388-byte sunspot-shaped proof

`http_chunk_prover(worker_urls)` returns a Dispatcher-compatible
chunk_prover callable that round-robins chunks across workers over HTTP --
the coordinator's WORKERS-env fan-out (prover-coordinator/main.rs:86-99)
with the same in-process Dispatcher driving it.

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

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def _json(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                return self._json(200, {
                    "status": "ok",
                    "capacity": list(prover.capacity),
                    "tree_depth": prover.tree_depth,
                })
            return self._json(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/prove":
                return self._json(404, {"error": "not found"})
            length = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(length)) if length else {}
            try:
                req = ChunkProveRequest.from_json(body)
                chunk = chunk_from_request(req)
                cp = prover.prove_chunk(chunk, req.batch_id)
                result = ProofResult(
                    chunk_index=cp.chunk_index,
                    proof=cp.proof_bytes.hex(),
                    public_inputs=[fr_to_hex(v) for v in cp.public_inputs],
                    proving_time_ms=cp.proving_time_ms,
                )
                payload = result.to_json()
                payload["public_witness"] = cp.public_witness.hex()
                return self._json(200, payload)
            except Exception as exc:
                return self._json(500, {"error": str(exc)})

    server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, server.server_address[1]


def http_chunk_prover(worker_urls: List[str], timeout: float = 600.0):
    """A Dispatcher-compatible chunk_prover that POSTs chunks to workers
    round-robin (the coordinator's cross-HOST axis; within one host the
    worker's own mesh of cards is the device axis)."""
    cycle = itertools.cycle(worker_urls)
    lock = threading.Lock()

    def prove(chunk: Chunk, batch_id: int) -> ChunkProof:
        with lock:
            url = next(cycle)
        req = urlrequest.Request(
            url + "/prove",
            data=json.dumps(chunk_to_request(chunk, batch_id)
                            .to_json()).encode(),
            headers={"Content-Type": "application/json"})
        with urlrequest.urlopen(req, timeout=timeout) as resp:
            payload = json.loads(resp.read())
        result = ProofResult.from_json(payload)
        return ChunkProof(
            chunk_index=result.chunk_index,
            proof_bytes=bytes.fromhex(result.proof),
            public_inputs=[fr_from_hex(h) for h in result.public_inputs],
            proving_time_ms=result.proving_time_ms,
            public_witness=bytes.fromhex(payload.get("public_witness", "")),
        )

    return prove
