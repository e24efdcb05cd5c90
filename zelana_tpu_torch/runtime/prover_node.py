"""Blind MPC prover node service + network coordinator client.

Mirror of forge/crates/prover-node/src/main.rs (:1-12): an HTTP server that
holds ONE Shamir share and participates in distributed Schnorr proving
WITHOUT ever seeing the witness or the full secret. Endpoints:

  GET  /health      -> {node_id, has_share}
  POST /share       -> accept a (blind) share assignment for a session
                       (prover-network ShareRequest)
  POST /commitment  -> round 1: fresh nonce, return R_i = k_i * G
                       (CommitmentRequest/Response)
  POST /fragment    -> round 2: z_i = k_i + c * lambda_i * share_i given
                       the coordinator's Fiat-Shamir challenge + Lagrange
                       coefficient (FragmentRequest/Response)

The node sees: its share, a session id, the challenge scalar. It never
sees: the secret, other shares, or (in the blind flow) the message -- the
coordinator derives the challenge from the witness commitment
(prover-network messages.rs blind variants).

`NodeNetworkCoordinator` is the driving side (prover-coordinator's role):
distributes shares over HTTP, collects k commitments, computes the
challenge, gathers fragments, aggregates, verifies -- the wire-level twin
of sdk.mpc.distributed_schnorr_prove."""

from __future__ import annotations

import json
import secrets
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple
from urllib import request as urlrequest

from ..curves import g1 as G1
from ..fields.bn254 import R as FR
from ..sdk.mpc import (
    FrShare,
    SchnorrProof,
    _challenge,
    lagrange_coefficient,
    share_secret,
)
from .messages import (
    CircuitType,
    CommitmentRequest,
    CommitmentResponse,
    FragmentRequest,
    FragmentResponse,
    ShareRequest,
    ShareResponse,
    fr_from_hex,
    fr_to_hex,
    point_from_hex,
    point_to_hex,
)


class ProverNodeState:
    def __init__(self, node_id: int):
        self.node_id = node_id
        self.shares: Dict[str, FrShare] = {}  # session_id -> share
        self.nonces: Dict[str, int] = {}  # session_id -> k_i (local only)
        self.lock = threading.Lock()

    # -- endpoint logic (transport-independent) ----------------------------

    def assign_share(self, req: ShareRequest) -> ShareResponse:
        with self.lock:
            if req.session_id in self.shares:
                return ShareResponse(req.session_id, False,
                                     "session already has a share")
            self.shares[req.session_id] = FrShare(
                req.index, fr_from_hex(req.share_value))
        return ShareResponse(req.session_id, True)

    def commitment(self, req: CommitmentRequest) -> CommitmentResponse:
        with self.lock:
            share = self.shares.get(req.session_id)
            if share is None:
                raise KeyError("no share for session")
            k = secrets.randbelow(FR - 1) + 1
            self.nonces[req.session_id] = k
        return CommitmentResponse(
            req.session_id, share.index,
            point_to_hex(G1.mul(G1.generator(), k)))

    def fragment(self, req: FragmentRequest) -> FragmentResponse:
        with self.lock:
            share = self.shares.get(req.session_id)
            k = self.nonces.pop(req.session_id, None)
            if share is None or k is None:
                raise KeyError("commit first")
        c = fr_from_hex(req.challenge)
        lam = fr_from_hex(req.lagrange)
        z = (k + c * lam % FR * share.value) % FR
        return FragmentResponse(req.session_id, share.index, fr_to_hex(z))


def start_prover_node(node_id: int, port: int = 0):
    """Boot the node HTTP service; returns (server, port, state)."""
    state = ProverNodeState(node_id)

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
                    "node_id": state.node_id,
                    "sessions": len(state.shares),
                })
            return self._json(404, {"error": "not found"})

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(length)) if length else {}
            try:
                if self.path == "/share":
                    resp = state.assign_share(ShareRequest.from_json(body))
                    return self._json(200 if resp.accepted else 400,
                                      resp.to_json())
                if self.path == "/commitment":
                    resp = state.commitment(
                        CommitmentRequest.from_json(body))
                    return self._json(200, resp.to_json())
                if self.path == "/fragment":
                    resp = state.fragment(FragmentRequest.from_json(body))
                    return self._json(200, resp.to_json())
                return self._json(404, {"error": "not found"})
            except KeyError as exc:
                return self._json(400, {"error": str(exc)})
            except Exception as exc:
                return self._json(500, {"error": str(exc)})

    server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, server.server_address[1], state


class NodeNetworkCoordinator:
    """HTTP-driving coordinator over a set of prover nodes (the wire-level
    counterpart of prover-coordinator's swarm flow)."""

    def __init__(self, node_urls: List[str]):
        self.node_urls = node_urls

    def _post(self, url: str, path: str, payload: dict) -> dict:
        req = urlrequest.Request(
            url + path, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urlrequest.urlopen(req, timeout=10) as resp:
            return json.loads(resp.read())

    def prove(self, secret: int, message: bytes, k: int = 3,
              session_id: Optional[str] = None
              ) -> Tuple[SchnorrProof, tuple]:
        """Shard the secret to the swarm and run the 2-round distributed
        Schnorr proof over HTTP; the nodes never see `secret` or each
        other's shares."""
        n = len(self.node_urls)
        assert 1 <= k <= n
        sid = session_id or secrets.token_hex(8)
        pk = G1.mul(G1.generator(), secret % FR)
        shares = share_secret(secret, k, n)
        for url, share in zip(self.node_urls, shares):
            resp = self._post(url, "/share", ShareRequest(
                sid, CircuitType.SCHNORR, share.index,
                fr_to_hex(share.value)).to_json())
            if not resp.get("accepted"):
                raise RuntimeError(f"share rejected: {resp}")

        # round 1: any k nodes commit
        chosen = self.node_urls[:k]
        commits = [
            CommitmentResponse.from_json(self._post(
                url, "/commitment", CommitmentRequest(sid).to_json()))
            for url in chosen
        ]
        r = None
        for c in commits:
            r = G1.add(r, point_from_hex(c.r_point))
        challenge = _challenge(r, pk, message)
        indices = [c.index for c in commits]

        # round 2: fragments with coordinator-computed Lagrange coefficients
        z = 0
        for url, c in zip(chosen, commits):
            lam = lagrange_coefficient(indices, c.index)
            frag = FragmentResponse.from_json(self._post(
                url, "/fragment",
                FragmentRequest(sid, fr_to_hex(challenge),
                                fr_to_hex(lam)).to_json()))
            z = (z + fr_from_hex(frag.z)) % FR
        return SchnorrProof(r, z), pk
