"""Three-stage batch pipeline: Accumulate -> Prove -> Settle.

Mirrors core/src/sequencer/pipeline.rs: parallel stages (a new batch
accumulates while the previous proves and an older one settles, :6-28),
ProverMode Mock/Groth16 (:59-67), settlement retries with exponential
backoff and pipeline pause after max retries (:430-701), operator
pause/resume commands and stats (:133-178, :770-951).

Proof-state note: the reference carries a latent inconsistency -- its
sequencer tracks MiMC SMT roots while its arkworks circuit enforces
Poseidon-fold roots (only the Mock prover path was exercised end to end).
This pipeline resolves it explicitly: the durable state roots remain the
MiMC tree roots (API/storage continuity), and when ProverMode is GROTH16
the public inputs handed to the prover are the circuit-native Poseidon fold
roots computed from the same balances, so real proofs verify end to end.

The orchestrator takes its prover (``prover_service.Groth16Prover`` on the
card, or any object with ``prove(inputs, witness)``) and raises without
one: the port has no hash-derived mock prover to fall back to.
"""

from __future__ import annotations

import enum
import hashlib
import json
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

from .account_tree import AccountState, AccountTree
from .batch import Batch, BatchConfig, BatchManager, BatchState
from .bridge import FastWithdrawManager, WithdrawalQueue
from .prover_service import (
    BatchPublicInputs,
    BatchWitness,
    build_witness,
)
from .settler import MockSettler
from .shielded_state import ShieldedState
from .store import Store
from .transactions import Shielded, Transfer, Withdraw, tx_kind
from .tx_router import TxRouter


def tx_hash(tx) -> bytes:
    """Canonical transaction hash for the tx index (db.rs tx_index CF)."""
    if hasattr(tx, "signing_message"):
        return hashlib.sha256(
            tx_kind(tx).encode() + b"\x00" + tx.signing_message()
        ).digest()
    if isinstance(tx, Shielded):
        return hashlib.sha256(
            b"zelana:shielded:v1" + tx.nullifier + tx.commitment
        ).digest()
    return hashlib.sha256(  # deposit
        b"zelana:deposit:v1"
        + tx.to
        + tx.amount.to_bytes(8, "little")
        + tx.l1_seq.to_bytes(8, "little")
    ).digest()


class ProverMode(enum.Enum):
    MOCK = "mock"
    GROTH16 = "groth16"


@dataclass
class PipelineConfig:
    batch: BatchConfig = field(default_factory=BatchConfig)
    prover_mode: ProverMode = ProverMode.MOCK
    poll_interval_secs: float = 0.1
    max_settlement_retries: int = 5
    settlement_backoff_base: float = 0.2


@dataclass
class PipelineStats:
    submitted: int = 0
    batches_proved: int = 0
    batches_settled: int = 0
    proving_time_ms_total: int = 0
    paused: bool = False


class PipelineOrchestrator:
    def __init__(self, store: Optional[Store] = None,
                 config: Optional[PipelineConfig] = None,
                 prover=None, settler=None, dev_mode: bool = True):
        if prover is None:
            raise ValueError(
                "PipelineOrchestrator needs a prover (prover_service."
                "Groth16Prover); the port has no mock prover")
        self.store = store or Store()
        self.config = config or PipelineConfig()
        self.tree = AccountTree()
        self.shielded = ShieldedState()
        self.router = TxRouter(self.get_account, self.shielded,
                               dev_mode=dev_mode)
        self.batches = BatchManager(self.router, self.tree, self.shielded,
                                    self.config.batch)
        self.prover = prover
        self.settler = settler or MockSettler()
        self.stats = PipelineStats()
        self._settle_retries = 0
        self._lock = threading.RLock()
        self._prove_inflight: Optional[Batch] = None  # stage-2 slot
        self._settle_inflight: Optional[Batch] = None  # stage-3 slot
        self._settle_not_before = 0.0  # retry backoff deadline (monotonic)
        # bridge-side services (bridge/{withdrawals,fast_withdrawals}.rs)
        self.withdrawals = WithdrawalQueue(self.store)
        self.fast_withdrawals = FastWithdrawManager()
        self._wd_by_hash = {}  # tx_hash -> withdrawal queue id
        self._fronted = set()  # withdrawal ids fronted by LPs
        self._pending_notes = {}  # commitment -> ciphertext (until settled)
        # threshold-encrypted mempool (mempool/threshold_mempool.rs); a dev
        # committee mirrors create_test_committee (core main.rs:204-208)
        from ..sdk.threshold import Committee, EncryptedMempool

        self.mempool = EncryptedMempool()
        self.committee = None
        self._committee_sks = None
        if dev_mode:
            committee, sks = Committee.create_test()
            self.committee = committee
            self._committee_sks = {
                m.index: sk for m, sk in zip(committee.members, sks)
            }

    # -- state access -------------------------------------------------------

    def get_account(self, account_id: bytes) -> AccountState:
        raw = self.store.get("accounts", account_id)
        if raw is None:
            return AccountState()
        balance = int.from_bytes(raw[:8], "little")
        nonce = int.from_bytes(raw[8:16], "little")
        return AccountState(balance, nonce)

    def get_pending_account(self, account_id: bytes):
        """In-flight state from the accumulating batch, if it differs from
        the finalized view (handlers.rs get_account's pending fields)."""
        cur = self.batches.current
        if cur is None:
            return None
        return cur.diff.account_updates.get(account_id)

    def _persist_account(self, account_id: bytes, state: AccountState):
        self.store.put(
            "accounts",
            account_id,
            state.balance.to_bytes(8, "little") + state.nonce.to_bytes(8, "little"),
        )

    # -- submission ---------------------------------------------------------

    def submit(self, tx):
        with self._lock:
            self.stats.submitted += 1
            result = self.batches.submit_transaction(tx)
            if result.accepted:
                h = tx_hash(tx)
                self._index_tx(h, tx, "pending")
                if isinstance(tx, Withdraw):
                    wd = self.withdrawals.enqueue(
                        tx.from_, tx.to_l1_address, tx.amount
                    )
                    self._wd_by_hash[h] = wd.id
                if isinstance(tx, Shielded) and tx.ciphertext:
                    # note ciphertext persists once the commitment lands in
                    # the tree at settlement (position known then)
                    self._pending_notes[tx.commitment] = tx.ciphertext
            return result

    def submit_encrypted(self, etx) -> bytes:
        """Queue a threshold-encrypted tx; decrypted at the next tick after
        blind ordering (threshold_mempool.rs)."""
        with self._lock:
            self.mempool.submit(etx)
            return etx.tx_id

    def _drain_encrypted(self):
        if not self.mempool.queue or self.committee is None:
            return
        from ..sdk.threshold import DecryptionCoordinator

        coordinator = DecryptionCoordinator(self.committee)
        pending, self.mempool.queue = self.mempool.ordered(), []
        for etx in pending:
            try:
                raw = coordinator.decrypt(etx, self._committee_sks)
                body = json.loads(raw)
                tx = Transfer(
                    signer_pubkey=bytes.fromhex(body["from"]),
                    to=bytes.fromhex(body["to"]),
                    amount=int(body["amount"]),
                    nonce=int(body["nonce"]),
                    signature=bytes.fromhex(body.get("signature", "")),
                )
            except Exception:
                continue  # undecryptable/garbled: drop (reference logs + skips)
            self.stats.submitted += 1
            self.batches.submit_transaction(tx)

    def execute_fast_withdraw(self, tx: Withdraw):
        """LP-fronted instant exit (fast_withdrawals.rs): the withdrawal goes
        through the normal batch path; the LP fronts the L1 payout now and is
        made whole (plus fee) when the batch settles."""
        with self._lock:
            if not self.fast_withdrawals.can_front(tx.amount):
                return None, "insufficient LP liquidity"
            result = self.submit(tx)
            if not result.accepted:
                return None, result.error
            received = self.fast_withdrawals.front(tx.amount)
            self._fronted.add(self._wd_by_hash[tx_hash(tx)])
            return received, None

    def seal(self) -> Optional[Batch]:
        with self._lock:
            return self.batches.seal()

    # -- tx / batch index (db.rs tx_index + batches CFs) ---------------------

    def _index_tx(self, h: bytes, tx, status: str, batch_id=None):
        record = {"kind": tx_kind(tx), "status": status, "batch_id": batch_id}
        if hasattr(tx, "amount"):
            record["amount"] = tx.amount
        self.store.put("tx_index", h, json.dumps(record).encode())

    def _set_tx_status(self, h: bytes, status: str, batch_id=None):
        raw = self.store.get("tx_index", h)
        if raw is None:
            return
        record = json.loads(raw)
        record["status"] = status
        if batch_id is not None:
            record["batch_id"] = batch_id
        self.store.put("tx_index", h, json.dumps(record).encode())

    def get_tx(self, h: bytes) -> Optional[dict]:
        raw = self.store.get("tx_index", h)
        return None if raw is None else json.loads(raw)

    def list_txs(self, limit: int = 100) -> list:
        out = []
        for key, raw in self.store.scan("tx_index"):
            record = json.loads(raw)
            record["tx_hash"] = key.hex()
            out.append(record)
            if len(out) >= limit:
                break
        return out

    def get_batch_record(self, batch_id: int) -> Optional[dict]:
        raw = self.store.get("batches", batch_id.to_bytes(8, "little"))
        return None if raw is None else json.loads(raw)

    def list_batch_records(self, limit: int = 100) -> list:
        out = []
        for _, raw in self.store.scan("batches"):
            out.append(json.loads(raw))
            if len(out) >= limit:
                break
        return out

    # -- pipeline tick ------------------------------------------------------

    def tick(self):
        if self.stats.paused:
            return
        with self._lock:
            self._drain_encrypted()
            self.batches.check_timeout()
            self._try_prove()
            self._try_settle()

    @property
    def proving_in_flight(self) -> bool:
        with self._lock:
            return self._prove_inflight is not None

    @property
    def settling_in_flight(self) -> bool:
        with self._lock:
            return self._settle_inflight is not None

    @property
    def settlement_pending(self) -> bool:
        """True while a settlement is in flight OR queued (including a
        failed attempt waiting out its retry backoff)."""
        with self._lock:
            return (self._settle_inflight is not None
                    or self.batches.next_for_settlement() is not None)

    def _fold_public_inputs(self, batch: Batch,
                            witness: BatchWitness) -> BatchPublicInputs:
        """Circuit-native public inputs (Poseidon folds over balances)."""
        from ..circuits.l2_block import (
            TransactionWitness,
            WithdrawalWitness,
            compute_batch_hash,
            compute_state_root,
            compute_withdrawal_root,
        )

        txs = [
            TransactionWitness(t.signer_pubkey, t.to, t.amount)
            for t in batch.transactions
            if isinstance(t, Transfer)
        ]
        wds = [
            WithdrawalWitness(t.to_l1_address, t.amount)
            for t in batch.transactions
            if isinstance(t, Withdraw)
        ]
        final = dict(witness.initial_accounts)
        for t in txs:
            final[t.sender_pk] = final.get(t.sender_pk, 0) - t.amount
            final[t.recipient_pk] = final.get(t.recipient_pk, 0) + t.amount
        for w, t in zip(wds, [t for t in batch.transactions if isinstance(t, Withdraw)]):
            final[t.from_] = final.get(t.from_, 0) - t.amount
        from ..circuits.l2_block import compute_shielded_root

        # shielded commitments ARE proven: the circuit folds them over the
        # pre root (the reference left this as prover.rs:402 TODO and
        # passed pre==post; we close it)
        return BatchPublicInputs(
            pre_state_root=compute_state_root(batch.id, witness.initial_accounts),
            post_state_root=compute_state_root(batch.id, final),
            pre_shielded_root=batch.pre_shielded_root,
            post_shielded_root=compute_shielded_root(
                batch.pre_shielded_root, witness.shielded_commitments),
            withdrawal_root=compute_withdrawal_root(wds),
            batch_hash=compute_batch_hash(batch.id, txs),
            batch_id=batch.id,
        )

    def _try_prove(self):
        """Stage 2 dispatch: pick the next sealed batch and hand it to the
        prover WORKER THREAD. The tick (and with it submission/settlement)
        never blocks on the prove -- accumulate, prove, and settle overlap
        across batches, mirroring the reference's spawn_blocking design
        (pipeline.rs:367-427). One prove in flight at a time (the stage has
        one slot; the reference's 3-stage pipeline likewise proves one
        batch while the next accumulates)."""
        if self._prove_inflight is not None:
            return
        batch = self.batches.next_for_proving()
        if batch is None:
            return
        batch.state = BatchState.PROVING
        for tx in batch.transactions:
            h = tx_hash(tx)
            self._set_tx_status(h, "in_batch", batch.id)
            wd_id = self._wd_by_hash.get(h)
            if wd_id is not None:
                self.withdrawals.mark_in_batch(wd_id, batch.id)
        witness = build_witness(batch, self.get_account)
        if self.config.prover_mode is ProverMode.GROTH16:
            inputs = self._fold_public_inputs(batch, witness)
        else:
            from .prover_service import build_public_inputs

            wd_root = self.batches.withdrawal_root(batch)
            inputs = build_public_inputs(batch, wd_root)
        self._prove_inflight = batch
        worker = threading.Thread(
            target=self._prove_worker, args=(batch, inputs, witness),
            daemon=True,
        )
        worker.start()

    def _prove_worker(self, batch: Batch, inputs, witness):
        """Runs OFF the tick thread; only result handling takes the lock."""
        try:
            proof = self.prover.prove(inputs, witness)
        except Exception as exc:  # prover failure: mark batch failed
            with self._lock:
                batch.state = BatchState.FAILED
                batch.error = f"prove failed: {exc}"
                self._prove_inflight = None
            return
        with self._lock:
            self.batches.batch_proved(batch, proof)
            self.stats.batches_proved += 1
            self.stats.proving_time_ms_total += proof.proving_time_ms
            self._prove_inflight = None

    def _try_settle(self):
        """Stage 3 dispatch: hand the next proved batch to a settler WORKER
        THREAD. The tick never blocks on L1 submission, and retry backoff is
        a deadline check here -- NOT a sleep under the lock -- so
        submissions proceed while a slow/failing settler retries (reference
        settles in a spawned task off the command loop, pipeline.rs:430-701)."""
        if self._settle_inflight is not None:
            return
        if time.monotonic() < self._settle_not_before:
            return
        batch = self.batches.next_for_settlement()
        if batch is None:
            return
        batch.state = BatchState.SETTLING
        self._settle_inflight = batch
        worker = threading.Thread(
            target=self._settle_worker, args=(batch,), daemon=True,
        )
        worker.start()

    def _settle_worker(self, batch: Batch):
        """Runs OFF the tick thread; only result handling takes the lock."""
        try:
            result = self.settler.submit(batch.proof)
        except Exception as exc:
            with self._lock:
                self._settle_inflight = None
                self._settle_retries += 1
                if self._settle_retries >= self.config.max_settlement_retries:
                    self.stats.paused = True
                    batch.state = BatchState.FAILED
                    batch.error = f"settlement failed: {exc}"
                else:
                    batch.state = BatchState.PROVED  # requeue after backoff
                    self._settle_not_before = time.monotonic() + (
                        self.config.settlement_backoff_base
                        * (2 ** self._settle_retries)
                    )
            return
        with self._lock:
            self._finalize_settlement(batch, result)
            self._settle_inflight = None
        # batched L1 withdrawal execution (settler.rs:694-860): settlers
        # with an execute_withdrawals leg get one WithdrawAttested per
        # finalized withdrawal, nullifier = the withdrawal tx hash.
        # Off the lock: this is another L1 network call.
        if hasattr(self.settler, "execute_withdrawals"):
            l1_wds = []
            for tx in batch.transactions:
                if isinstance(tx, Withdraw):
                    l1_wds.append(
                        (tx.to_l1_address, tx.amount, tx_hash(tx)))
            if l1_wds:
                try:
                    self.settler.execute_withdrawals(l1_wds)
                except Exception:
                    pass  # L1 withdrawal execution retries ride the queue

    def _finalize_settlement(self, batch: Batch, result):
        self._settle_retries = 0
        note_position = self.shielded.tree.next_index  # pre-commit position
        self.batches.batch_settled(batch, result.signature)
        for i, cm in enumerate(batch.diff.new_commitments):
            ciphertext = self._pending_notes.pop(cm, None)
            if ciphertext is not None:
                self.store.put(
                    "encrypted_notes",
                    (note_position + i).to_bytes(8, "little"),
                    cm + ciphertext,
                )
        # persist committed account state
        for account_id, state in batch.diff.account_updates.items():
            self._persist_account(account_id, state)
        for nf in batch.diff.new_nullifiers:
            self.store.put("nullifiers", nf, b"\x01")
        for cm in batch.diff.new_commitments:
            self.store.put("commitments", cm, b"\x01")
        for tx in batch.transactions:
            h = tx_hash(tx)
            self._set_tx_status(h, "finalized", batch.id)
            wd_id = self._wd_by_hash.get(h)
            if wd_id is not None:
                self.withdrawals.mark_submitted(wd_id, result.signature)
                self.withdrawals.mark_finalized(wd_id)
                if wd_id in self._fronted:
                    self._fronted.discard(wd_id)
                    self.fast_withdrawals.settle(
                        self.withdrawals.items[wd_id].amount
                    )
        self.store.put(
            "batches",
            batch.id.to_bytes(8, "little"),
            json.dumps({
                "id": batch.id,
                "state": batch.state.value,
                "txs": len(batch.transactions),
                "transfers": batch.num_transfers,
                "withdrawals": batch.num_withdrawals,
                "shielded": batch.num_shielded,
                "signature": result.signature,
            }).encode(),
        )
        self.stats.batches_settled += 1

    # -- operator commands --------------------------------------------------

    def pause(self):
        self.stats.paused = True

    def resume(self):
        self.stats.paused = False
        self._settle_retries = 0


class PipelineService:
    """Background thread driving the orchestrator (pipeline.rs:770-951)."""

    def __init__(self, orchestrator: PipelineOrchestrator):
        self.orchestrator = orchestrator
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.is_set():
            self.orchestrator.tick()
            self._stop.wait(self.orchestrator.config.poll_interval_secs)

    def submit(self, tx):
        return self.orchestrator.submit(tx)

    def stop(self):
        # graceful shutdown: seal the pending batch first (pipeline.rs:836-852)
        self.orchestrator.seal()
        deadline = time.time() + 10.0
        while time.time() < deadline:
            self.orchestrator.tick()
            pending = (
                self.orchestrator.proving_in_flight
                or self.orchestrator.batches.next_for_proving()
                or self.orchestrator.settlement_pending
            )
            if not pending:
                break
            time.sleep(0.02)
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
