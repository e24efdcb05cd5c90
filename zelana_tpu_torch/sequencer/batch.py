"""Batch lifecycle management.

Mirrors core/src/sequencer/execution/batch.rs: state machine Accumulating ->
Sealed -> Proving -> Proved -> Settling -> Finalized (:21-28), with seal
triggers max_txs=100 / max_age=60s / max_shielded=10 (:52-71), and
prepare-for-proving building the MiMC withdrawal root + witness (:700-755).
"""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

from .account_tree import AccountTree, compute_withdrawal_root_mimc
from .shielded_state import ShieldedState
from .transactions import Deposit, Shielded, Transfer, Withdraw
from .tx_router import BatchDiff, TxResult, TxRouter


class BatchState(enum.Enum):
    ACCUMULATING = "accumulating"
    SEALED = "sealed"
    PROVING = "proving"
    PROVED = "proved"
    SETTLING = "settling"
    FINALIZED = "finalized"
    FAILED = "failed"


@dataclass
class BatchConfig:
    max_txs: int = 100
    max_age_secs: float = 60.0
    max_shielded: int = 10
    dev_immediate_commit: bool = False


@dataclass
class Batch:
    id: int
    state: BatchState = BatchState.ACCUMULATING
    transactions: List[object] = field(default_factory=list)
    results: List[TxResult] = field(default_factory=list)
    diff: BatchDiff = field(default_factory=BatchDiff)
    batch_nullifiers: Set[bytes] = field(default_factory=set)
    created_at: float = field(default_factory=time.time)
    pre_state_root: bytes = b"\x00" * 32
    post_state_root: Optional[bytes] = None
    pre_shielded_root: bytes = b"\x00" * 32
    post_shielded_root: Optional[bytes] = None
    proof: Optional[object] = None
    settlement_sig: Optional[str] = None
    error: Optional[str] = None

    @property
    def num_shielded(self) -> int:
        return sum(1 for t in self.transactions if isinstance(t, Shielded))

    @property
    def num_transfers(self) -> int:
        return sum(1 for t in self.transactions if isinstance(t, Transfer))

    @property
    def num_withdrawals(self) -> int:
        return sum(1 for t in self.transactions if isinstance(t, Withdraw))


@dataclass
class BatchManagerStats:
    submitted: int = 0
    accepted: int = 0
    rejected: int = 0
    sealed_batches: int = 0
    finalized_batches: int = 0


class BatchManager:
    def __init__(self, router: TxRouter, tree: AccountTree,
                 shielded: ShieldedState,
                 config: Optional[BatchConfig] = None):
        self.router = router
        self.tree = tree
        self.shielded = shielded
        self.config = config or BatchConfig()
        self.next_batch_id = 0
        self.current: Optional[Batch] = None
        self.sealed: List[Batch] = []
        self.stats = BatchManagerStats()

    def _open_batch(self) -> Batch:
        batch = Batch(
            id=self.next_batch_id,
            pre_state_root=self.tree.root(),
            pre_shielded_root=self.shielded.root(),
        )
        self.next_batch_id += 1
        self.current = batch
        return batch

    def submit_transaction(self, tx) -> TxResult:
        self.stats.submitted += 1
        batch = self.current or self._open_batch()
        result = self.router.execute_single(tx, batch.diff, batch.batch_nullifiers)
        if result.accepted:
            batch.transactions.append(tx)
            batch.results.append(result)
            self.stats.accepted += 1
        else:
            self.stats.rejected += 1
        if self.should_seal(batch):
            self.seal()
        return result

    def should_seal(self, batch: Batch) -> bool:
        if not batch.transactions:
            return False
        if len(batch.transactions) >= self.config.max_txs:
            return True
        if batch.num_shielded >= self.config.max_shielded:
            return True
        return time.time() - batch.created_at >= self.config.max_age_secs

    def check_timeout(self):
        if self.current and self.current.transactions and (
            time.time() - self.current.created_at >= self.config.max_age_secs
        ):
            self.seal()

    def seal(self) -> Optional[Batch]:
        batch = self.current
        if batch is None or not batch.transactions:
            return None
        # execute state transition to compute post roots (on clones; the
        # authoritative commit happens at finalization)
        sim_tree = self.tree.clone()
        for account_id, state in batch.diff.account_updates.items():
            sim_tree.insert(account_id, state)
        batch.post_state_root = sim_tree.root()

        # shielded post root: simulate insertions
        import copy

        sim_shielded_tree = copy.deepcopy(self.shielded.tree)
        for cm in batch.diff.new_commitments:
            sim_shielded_tree.insert(cm)
        batch.post_shielded_root = sim_shielded_tree.root()

        batch.state = BatchState.SEALED
        self.sealed.append(batch)
        self.current = None
        self.stats.sealed_batches += 1
        return batch

    def next_for_proving(self) -> Optional[Batch]:
        for batch in self.sealed:
            if batch.state == BatchState.SEALED:
                return batch
        return None

    def next_for_settlement(self) -> Optional[Batch]:
        for batch in self.sealed:
            if batch.state == BatchState.PROVED:
                return batch
        return None

    def batch_proved(self, batch: Batch, proof):
        batch.proof = proof
        batch.state = BatchState.PROVED

    def batch_settled(self, batch: Batch, signature: str):
        batch.settlement_sig = signature
        batch.state = BatchState.SETTLING
        self.finalize(batch)

    def finalize(self, batch: Batch):
        """Commit the diff to the authoritative state."""
        self.router.commit(batch.diff, self.tree, self.shielded)
        batch.state = BatchState.FINALIZED
        self.stats.finalized_batches += 1

    def withdrawal_root(self, batch: Batch) -> bytes:
        items = [
            (
                int.from_bytes(w.to_l1_address, "big"),
                w.amount,
                int.from_bytes(w.from_, "big"),
            )
            for w in batch.diff.withdrawals
        ]
        return compute_withdrawal_root_mimc(batch.id, items)
