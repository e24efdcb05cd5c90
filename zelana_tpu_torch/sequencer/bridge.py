"""Bridge-side bookkeeping: deposits, withdrawal queue, fast withdrawals.

Mirrors core/src/sequencer/bridge/:

- deposit ingest (ingest.rs): parses `ZE_DEPOSIT:<pk>:<amt>:<nonce>` log
  lines from the L1 bridge program, dedups by l1_seq, persists the last
  processed slot, routes into the pipeline. The log source is pluggable:
  an iterator for tests, or the real WebSocket `logsSubscribe` transport
  in sequencer/ws.py (`start_ws_indexer`, mirroring the reference's
  Solana pubsub subscription + reconnect).
- withdrawal queue (withdrawals.rs): Pending -> InBatch -> Submitted ->
  Finalized tracking plus the withdrawal Merkle root.
- fast withdrawals (fast_withdrawals.rs): LP-fronted instant exits with
  basis-point fees and a collateral ratio guard.
"""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .store import Store
from .transactions import Deposit


# ---------------------------------------------------------------------------
# deposit ingest
# ---------------------------------------------------------------------------

DEPOSIT_LOG_PREFIX = "ZE_DEPOSIT:"


@dataclass
class IndexerConfig:
    bridge_program: str = ""
    max_historical_slots: int = 10_000


class DepositIndexer:
    def __init__(self, store: Store, submit, config: Optional[IndexerConfig] = None):
        self.store = store
        self.submit = submit  # pipeline submit callable
        self.config = config or IndexerConfig()

    def last_processed_slot(self) -> int:
        raw = self.store.get("indexer_meta", b"last_slot")
        return int.from_bytes(raw, "little") if raw else 0

    def _set_last_slot(self, slot: int):
        self.store.put("indexer_meta", b"last_slot", slot.to_bytes(8, "little"))

    def process_log(self, slot: int, log_line: str) -> bool:
        """Returns True if a deposit was ingested."""
        if DEPOSIT_LOG_PREFIX not in log_line:
            return False
        payload = log_line.split(DEPOSIT_LOG_PREFIX, 1)[1]
        parts = payload.strip().split(":")
        if len(parts) != 3:
            return False
        pk_hex, amount_s, nonce_s = parts
        l1_seq = int(nonce_s)
        seq_key = l1_seq.to_bytes(8, "little")
        if self.store.exists("processed_deposits", seq_key):
            return False  # dedup
        tx = Deposit(to=bytes.fromhex(pk_hex), amount=int(amount_s),
                     l1_seq=l1_seq)
        result = self.submit(tx)
        if result.accepted:
            self.store.put("processed_deposits", seq_key, b"\x01")
            self._set_last_slot(slot)
            return True
        return False

    def catch_up(self, logs):
        """logs: iterable of (slot, line); replays history after restart."""
        start = self.last_processed_slot()
        count = 0
        for slot, line in logs:
            if slot <= start:
                continue
            if self.process_log(slot, line):
                count += 1
        return count


# ---------------------------------------------------------------------------
# withdrawal queue
# ---------------------------------------------------------------------------


class WithdrawalState(enum.Enum):
    PENDING = "pending"
    IN_BATCH = "in_batch"
    SUBMITTED = "submitted"
    FINALIZED = "finalized"


@dataclass
class TrackedWithdrawal:
    id: int
    from_l2: bytes
    to_l1: bytes
    amount: int
    state: WithdrawalState = WithdrawalState.PENDING
    batch_id: Optional[int] = None
    l1_signature: Optional[str] = None
    created_at: float = field(default_factory=time.time)


class WithdrawalQueue:
    def __init__(self, store: Optional[Store] = None):
        self.store = store
        self.items: Dict[int, TrackedWithdrawal] = {}
        self.next_id = 0

    def enqueue(self, from_l2: bytes, to_l1: bytes, amount: int) -> TrackedWithdrawal:
        wd = TrackedWithdrawal(self.next_id, from_l2, to_l1, amount)
        self.items[wd.id] = wd
        self.next_id += 1
        return wd

    def mark_in_batch(self, wd_id: int, batch_id: int):
        wd = self.items[wd_id]
        wd.state = WithdrawalState.IN_BATCH
        wd.batch_id = batch_id

    def mark_submitted(self, wd_id: int, signature: str):
        wd = self.items[wd_id]
        wd.state = WithdrawalState.SUBMITTED
        wd.l1_signature = signature

    def mark_finalized(self, wd_id: int):
        self.items[wd_id].state = WithdrawalState.FINALIZED

    def pending(self) -> List[TrackedWithdrawal]:
        return [w for w in self.items.values()
                if w.state == WithdrawalState.PENDING]

    def build_merkle_root(self, batch_id: int) -> bytes:
        from .account_tree import compute_withdrawal_root_mimc

        items = [
            (int.from_bytes(w.to_l1, "big"), w.amount,
             int.from_bytes(w.from_l2, "big"))
            for w in self.items.values()
            if w.batch_id == batch_id
        ]
        return compute_withdrawal_root_mimc(batch_id, items)


# ---------------------------------------------------------------------------
# fast withdrawals (LP-fronted)
# ---------------------------------------------------------------------------


@dataclass
class FastWithdrawConfig:
    fee_bps: int = 30  # 0.30%
    min_collateral_ratio: float = 1.2
    max_instant_amount: int = 10_000_000_000


class FastWithdrawManager:
    def __init__(self, config: Optional[FastWithdrawConfig] = None):
        self.config = config or FastWithdrawConfig()
        self.lp_liquidity: Dict[bytes, int] = {}
        self.outstanding: int = 0

    def add_liquidity(self, lp: bytes, amount: int):
        self.lp_liquidity[lp] = self.lp_liquidity.get(lp, 0) + amount

    def total_liquidity(self) -> int:
        return sum(self.lp_liquidity.values())

    def quote(self, amount: int) -> int:
        """Amount the user receives instantly after the LP fee."""
        fee = amount * self.config.fee_bps // 10_000
        return amount - fee

    def can_front(self, amount: int) -> bool:
        if amount > self.config.max_instant_amount:
            return False
        available = self.total_liquidity() - self.outstanding
        return available >= amount * self.config.min_collateral_ratio

    def front(self, amount: int) -> int:
        if not self.can_front(amount):
            raise ValueError("insufficient LP liquidity")
        self.outstanding += amount
        return self.quote(amount)

    def settle(self, amount: int):
        """L1 settlement arrived; release the fronted amount."""
        self.outstanding = max(0, self.outstanding - amount)
