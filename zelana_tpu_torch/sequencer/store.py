"""Durable column-family KV store (sqlite-backed).

Plays the role of the reference's RocksDB store
(core/src/sequencer/storage/db.rs) with the same 14 column families
(:97-149) and atomic batch application (:673). sqlite3 is the stdlib's
C-native embedded store; each CF is a table with BLOB key/value and batches
commit in one transaction.
"""

from __future__ import annotations

import sqlite3
import threading
from typing import Dict, Iterable, List, Optional, Tuple

COLUMN_FAMILIES = [
    "accounts",
    "blocks",
    "tx_index",
    "tx_blobs",
    "batches",
    "nullifiers",
    "commitments",
    "encrypted_notes",
    "withdrawals",
    "tree_meta",
    "processed_deposits",
    "indexer_meta",
    "stats",
    "delegations",
]


class Store:
    def __init__(self, path: str = ":memory:"):
        self.path = path
        # one shared connection: a per-thread connection would split an
        # in-memory database per thread; sqlite serializes through our lock
        self._lock = threading.RLock()
        self._shared = sqlite3.connect(self.path, check_same_thread=False)
        self._shared.execute("PRAGMA journal_mode=WAL")
        self._shared.execute("PRAGMA synchronous=NORMAL")
        self._init_schema()

    def _conn(self) -> sqlite3.Connection:
        return self._shared

    def _init_schema(self):
        conn = self._conn()
        with conn:
            for cf in COLUMN_FAMILIES:
                conn.execute(
                    f"CREATE TABLE IF NOT EXISTS cf_{cf} "
                    "(k BLOB PRIMARY KEY, v BLOB NOT NULL)"
                )

    # -- point ops ----------------------------------------------------------

    def get(self, cf: str, key: bytes) -> Optional[bytes]:
        with self._lock:
            row = self._conn().execute(
                f"SELECT v FROM cf_{cf} WHERE k = ?", (key,)
            ).fetchone()
        return row[0] if row else None

    def put(self, cf: str, key: bytes, value: bytes):
        with self._lock, self._conn() as conn:
            conn.execute(
                f"INSERT OR REPLACE INTO cf_{cf} (k, v) VALUES (?, ?)",
                (key, value),
            )

    def delete(self, cf: str, key: bytes):
        with self._lock, self._conn() as conn:
            conn.execute(f"DELETE FROM cf_{cf} WHERE k = ?", (key,))

    def exists(self, cf: str, key: bytes) -> bool:
        return self.get(cf, key) is not None

    def scan(self, cf: str, prefix: bytes = b"") -> Iterable[Tuple[bytes, bytes]]:
        with self._lock:
            if prefix:
                hi = prefix + b"\xff" * 8
                rows = self._conn().execute(
                    f"SELECT k, v FROM cf_{cf} WHERE k >= ? AND k <= ? ORDER BY k",
                    (prefix, hi),
                ).fetchall()
            else:
                rows = self._conn().execute(
                    f"SELECT k, v FROM cf_{cf} ORDER BY k"
                ).fetchall()
        yield from rows

    def count(self, cf: str) -> int:
        with self._lock:
            return self._conn().execute(
                f"SELECT COUNT(*) FROM cf_{cf}"
            ).fetchone()[0]

    # -- atomic batches -----------------------------------------------------

    def apply_batch(self, ops: List[Tuple[str, str, bytes, Optional[bytes]]]):
        """ops: list of ("put"|"delete", cf, key, value)."""
        conn = self._conn()
        with self._lock, conn:
            for op, cf, key, value in ops:
                if op == "put":
                    conn.execute(
                        f"INSERT OR REPLACE INTO cf_{cf} (k, v) VALUES (?, ?)",
                        (key, value),
                    )
                elif op == "delete":
                    conn.execute(f"DELETE FROM cf_{cf} WHERE k = ?", (key,))
                else:
                    raise ValueError(op)

    def close(self):
        with self._lock:
            self._shared.close()
