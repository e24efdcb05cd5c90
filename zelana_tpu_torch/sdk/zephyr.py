"""Zephyr encrypted UDP transport (mirror of sdk/zephyr + core udp_server).

Packet protocol (sdk/zephyr/src/packet.rs:3-21):
    type 1 ClientHello  [1 | client_x25519_pk(32)]
    type 2 ServerHello  [2 | server_x25519_pk(32)]
    type 3 AppData      [3 | nonce(12) | ciphertext+tag]

Session keys: X25519 ECDH -> HKDF("zelana-zephyr-v1") -> ChaCha20-Poly1305
(keys.rs:36-100). The server keeps an address-keyed session table with a
5-minute timeout (core/src/api/udp_server.rs:33-39). Payloads are JSON
transaction submissions routed into the pipeline like HTTP ones.
"""

from __future__ import annotations

import json
import os
import socket
import socketserver
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

from . import aead

CLIENT_HELLO = 1
SERVER_HELLO = 2
APP_DATA = 3

HKDF_INFO = b"zelana-zephyr-v1"
SESSION_TIMEOUT = 300.0


def derive_session_keys(shared: bytes) -> Tuple[bytes, bytes]:
    """(client->server key, server->client key)."""
    okm = aead.hkdf_sha256(shared, HKDF_INFO, length=64)
    return okm[:32], okm[32:]


@dataclass
class Session:
    c2s_key: bytes
    s2c_key: bytes
    last_seen: float


class ZephyrServer:
    def __init__(self, handler: Callable[[dict], dict], port: int = 0):
        self.handler = handler
        self.sk, self.pk = aead.x25519_keypair()
        self.sessions: Dict[tuple, Session] = {}
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind(("127.0.0.1", port))
        self.port = self.sock.getsockname()[1]
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _gc_sessions(self):
        now = time.time()
        dead = [a for a, s in self.sessions.items()
                if now - s.last_seen > SESSION_TIMEOUT]
        for a in dead:
            del self.sessions[a]

    def _run(self):
        self.sock.settimeout(0.2)
        while not self._stop.is_set():
            try:
                data, addr = self.sock.recvfrom(65535)
            except socket.timeout:
                continue
            except OSError:
                break
            self._gc_sessions()
            if not data:
                continue
            ptype = data[0]
            if ptype == CLIENT_HELLO and len(data) == 33:
                client_pk = data[1:]
                shared = aead.x25519(self.sk, client_pk)
                c2s, s2c = derive_session_keys(shared)
                self.sessions[addr] = Session(c2s, s2c, time.time())
                self.sock.sendto(bytes([SERVER_HELLO]) + self.pk, addr)
            elif ptype == APP_DATA and len(data) > 13:
                sess = self.sessions.get(addr)
                if sess is None:
                    continue
                nonce, ct = data[1:13], data[13:]
                try:
                    pt = aead.chacha20poly1305_decrypt(sess.c2s_key, nonce, ct)
                except ValueError:
                    continue
                sess.last_seen = time.time()
                try:
                    request = json.loads(pt)
                    response = self.handler(request)
                except Exception as exc:
                    response = {"error": str(exc)}
                rnonce = os.urandom(12)
                rct = aead.chacha20poly1305_encrypt(
                    sess.s2c_key, rnonce, json.dumps(response).encode()
                )
                self.sock.sendto(bytes([APP_DATA]) + rnonce + rct, addr)

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)
        self.sock.close()


class ZephyrClient:
    def __init__(self, server_addr: Tuple[str, int], timeout: float = 5.0):
        self.server_addr = server_addr
        self.sk, self.pk = aead.x25519_keypair()
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.settimeout(timeout)
        self.c2s_key: Optional[bytes] = None
        self.s2c_key: Optional[bytes] = None

    def handshake(self):
        self.sock.sendto(bytes([CLIENT_HELLO]) + self.pk, self.server_addr)
        data, _ = self.sock.recvfrom(65535)
        assert data[0] == SERVER_HELLO and len(data) == 33
        shared = aead.x25519(self.sk, data[1:])
        self.c2s_key, self.s2c_key = derive_session_keys(shared)

    def request(self, payload: dict) -> dict:
        assert self.c2s_key is not None, "handshake first"
        nonce = os.urandom(12)
        ct = aead.chacha20poly1305_encrypt(
            self.c2s_key, nonce, json.dumps(payload).encode()
        )
        self.sock.sendto(bytes([APP_DATA]) + nonce + ct, self.server_addr)
        data, _ = self.sock.recvfrom(65535)
        assert data[0] == APP_DATA
        pt = aead.chacha20poly1305_decrypt(self.s2c_key, data[1:13], data[13:])
        return json.loads(pt)

    def close(self):
        self.sock.close()
