"""Minimal RFC 6455 WebSocket layer + Solana-PubSub log subscription.

The reference's deposit indexer subscribes to the L1 over Solana's
WebSocket pubsub (`logsSubscribe` on the bridge program,
core/src/sequencer/bridge/ingest.rs:13-46). This environment has no
egress, so round 2 left the indexer's feed as a plain iterator; this
module supplies the real transport: a stdlib-only WebSocket client (the
indexer side), a server (for tests / the local validator model), and the
Solana pubsub JSON-RPC shapes (`logsSubscribe` -> subscription id ->
`logsNotification` messages).

Protocol scope: HTTP/1.1 Upgrade handshake (Sec-WebSocket-Accept =
b64(sha1(key + RFC GUID))), text/close/ping frames, client->server
masking (mandatory per RFC 6455 5.3), 7/16/64-bit payload lengths.
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
import socket
import struct
import threading
from typing import Callable, Optional, Tuple

_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

OP_TEXT = 0x1
OP_CLOSE = 0x8
OP_PING = 0x9
OP_PONG = 0xA


def accept_key(client_key: str) -> str:
    digest = hashlib.sha1((client_key + _GUID).encode()).digest()
    return base64.b64encode(digest).decode()


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------


def encode_frame(opcode: int, payload: bytes, mask: bool) -> bytes:
    head = bytearray([0x80 | opcode])
    n = len(payload)
    mask_bit = 0x80 if mask else 0
    if n < 126:
        head.append(mask_bit | n)
    elif n < (1 << 16):
        head.append(mask_bit | 126)
        head += struct.pack(">H", n)
    else:
        head.append(mask_bit | 127)
        head += struct.pack(">Q", n)
    if mask:
        key = os.urandom(4)
        head += key
        payload = bytes(b ^ key[i % 4] for i, b in enumerate(payload))
    return bytes(head) + payload


def _read_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("websocket peer closed")
        buf += chunk
    return buf


def read_frame(sock: socket.socket) -> Tuple[int, bytes]:
    """Returns (opcode, payload); unmasks if the peer masked."""
    b0, b1 = _read_exact(sock, 2)
    opcode = b0 & 0x0F
    masked = bool(b1 & 0x80)
    n = b1 & 0x7F
    if n == 126:
        (n,) = struct.unpack(">H", _read_exact(sock, 2))
    elif n == 127:
        (n,) = struct.unpack(">Q", _read_exact(sock, 8))
    key = _read_exact(sock, 4) if masked else None
    payload = _read_exact(sock, n) if n else b""
    if key:
        payload = bytes(b ^ key[i % 4] for i, b in enumerate(payload))
    return opcode, payload


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------


class WsClient:
    """Blocking WebSocket client (the indexer's subscription transport)."""

    def __init__(self, host: str, port: int, path: str = "/",
                 timeout: float = 10.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        key = base64.b64encode(os.urandom(16)).decode()
        request = (
            f"GET {path} HTTP/1.1\r\n"
            f"Host: {host}:{port}\r\n"
            "Upgrade: websocket\r\n"
            "Connection: Upgrade\r\n"
            f"Sec-WebSocket-Key: {key}\r\n"
            "Sec-WebSocket-Version: 13\r\n\r\n"
        )
        self.sock.sendall(request.encode())
        response = b""
        while b"\r\n\r\n" not in response:
            chunk = self.sock.recv(4096)
            if not chunk:
                raise ConnectionError("handshake failed: peer closed")
            response += chunk
        head = response.split(b"\r\n\r\n", 1)[0].decode()
        if "101" not in head.split("\r\n")[0]:
            raise ConnectionError(f"handshake rejected: {head.splitlines()[0]}")
        want = accept_key(key)
        for line in head.split("\r\n")[1:]:
            if line.lower().startswith("sec-websocket-accept:"):
                got = line.split(":", 1)[1].strip()
                if got != want:
                    raise ConnectionError("bad Sec-WebSocket-Accept")
                break
        else:
            raise ConnectionError("missing Sec-WebSocket-Accept")

    def send_text(self, text: str):
        self.sock.sendall(encode_frame(OP_TEXT, text.encode(), mask=True))

    def recv_text(self) -> Optional[str]:
        """Next text payload; answers pings; None on close."""
        while True:
            opcode, payload = read_frame(self.sock)
            if opcode == OP_TEXT:
                return payload.decode()
            if opcode == OP_PING:
                self.sock.sendall(encode_frame(OP_PONG, payload, mask=True))
                continue
            if opcode == OP_CLOSE:
                return None

    def close(self):
        try:
            self.sock.sendall(encode_frame(OP_CLOSE, b"", mask=True))
        except OSError:
            pass
        self.sock.close()


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------


class WsServer:
    """Threaded WebSocket server; `handler(conn)` per connection."""

    def __init__(self, handler: Callable, host: str = "127.0.0.1",
                 port: int = 0):
        self.handler = handler
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind((host, port))
        self.sock.listen(8)
        self.port = self.sock.getsockname()[1]
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._thread.start()

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _addr = self.sock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve_one, args=(conn,),
                             daemon=True).start()

    def _serve_one(self, conn: socket.socket):
        try:
            request = b""
            while b"\r\n\r\n" not in request:
                chunk = conn.recv(4096)
                if not chunk:
                    return
                request += chunk
            key = None
            for line in request.split(b"\r\n"):
                if line.lower().startswith(b"sec-websocket-key:"):
                    key = line.split(b":", 1)[1].strip().decode()
            if key is None:
                conn.sendall(b"HTTP/1.1 400 Bad Request\r\n\r\n")
                return
            conn.sendall((
                "HTTP/1.1 101 Switching Protocols\r\n"
                "Upgrade: websocket\r\n"
                "Connection: Upgrade\r\n"
                f"Sec-WebSocket-Accept: {accept_key(key)}\r\n\r\n"
            ).encode())
            self.handler(_ServerConn(conn))
        except (ConnectionError, OSError):
            pass
        finally:
            conn.close()

    def close(self):
        self._stop.set()
        self.sock.close()


class _ServerConn:
    def __init__(self, sock: socket.socket):
        self.sock = sock

    def send_text(self, text: str):
        self.sock.sendall(encode_frame(OP_TEXT, text.encode(), mask=False))

    def recv_text(self) -> Optional[str]:
        while True:
            opcode, payload = read_frame(self.sock)
            if opcode == OP_TEXT:
                return payload.decode()
            if opcode == OP_PING:
                self.sock.sendall(encode_frame(OP_PONG, payload, mask=False))
                continue
            if opcode == OP_CLOSE:
                return None


# ---------------------------------------------------------------------------
# Solana pubsub shapes (ingest.rs's wire protocol)
# ---------------------------------------------------------------------------


class LogsSubscribeServer:
    """Solana-PubSub-shaped server: accepts `logsSubscribe` JSON-RPC and
    pushes `logsNotification` messages (the local validator model for
    tests and the e2e tool)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._subs = []  # (conn, sub_id)
        self._lock = threading.Lock()
        self._next_sub = 1
        self.server = WsServer(self._handle, host, port)
        self.port = self.server.port

    def _handle(self, conn: _ServerConn):
        while True:
            text = conn.recv_text()
            if text is None:
                with self._lock:
                    self._subs = [s for s in self._subs if s[0] is not conn]
                return
            try:
                req = json.loads(text)
            except json.JSONDecodeError:
                continue
            if req.get("method") == "logsSubscribe":
                with self._lock:
                    sub_id = self._next_sub
                    self._next_sub += 1
                    self._subs.append((conn, sub_id))
                conn.send_text(json.dumps(
                    {"jsonrpc": "2.0", "result": sub_id,
                     "id": req.get("id")}))

    def publish(self, slot: int, logs: list, signature: str = "1" * 88):
        """Push one logsNotification to every subscriber."""
        with self._lock:
            subs = list(self._subs)
        for conn, sub_id in subs:
            try:
                conn.send_text(json.dumps({
                    "jsonrpc": "2.0",
                    "method": "logsNotification",
                    "params": {
                        "subscription": sub_id,
                        "result": {
                            "context": {"slot": slot},
                            "value": {"signature": signature,
                                      "err": None, "logs": logs},
                        },
                    },
                }))
            except OSError:
                with self._lock:
                    self._subs = [s for s in self._subs if s[0] is not conn]

    def close(self):
        self.server.close()


def ws_log_feed(host: str, port: int, bridge_program: str):
    """Generator of (slot, log_line) from a logsSubscribe stream --
    plugs straight into DepositIndexer.process_log. Sends the same
    subscribe request shape as ingest.rs (mentions filter + commitment)."""
    client = WsClient(host, port)
    client.send_text(json.dumps({
        "jsonrpc": "2.0", "id": 1, "method": "logsSubscribe",
        "params": [
            {"mentions": [bridge_program]},
            {"commitment": "confirmed"},
        ],
    }))
    ack = client.recv_text()  # subscription confirmation
    if ack is None:
        return
    try:
        while True:
            text = client.recv_text()
            if text is None:
                return
            try:
                msg = json.loads(text)
            except json.JSONDecodeError:
                continue
            if msg.get("method") != "logsNotification":
                continue
            result = msg["params"]["result"]
            slot = result["context"]["slot"]
            for line in result["value"]["logs"]:
                yield slot, line
    finally:
        client.close()


def start_ws_indexer(indexer, host: str, port: int, bridge_program: str,
                     reconnect_delay: float = 1.0,
                     stop_event: Optional[threading.Event] = None
                     ) -> threading.Thread:
    """Background thread driving a DepositIndexer from a WS log feed,
    with reconnect (ingest.rs reconnect + catch-up shape)."""
    stop = stop_event or threading.Event()

    def run():
        while not stop.is_set():
            try:
                for slot, line in ws_log_feed(host, port, bridge_program):
                    indexer.process_log(slot, line)
                    if stop.is_set():
                        return
            except (ConnectionError, OSError):
                pass
            stop.wait(reconnect_delay)

    thread = threading.Thread(target=run, daemon=True)
    thread.stop = stop  # cooperative shutdown handle
    thread.start()
    return thread
