"""Distributed proving coordinator (mirror of forge/crates/prover-coordinator).

The reference's "brain": slice a batch into fixed-capacity chunks, compute
the intermediate state roots chaining chunk proofs, dispatch chunks to
workers in parallel, collect the proofs, and expose a job API
(prover-coordinator/src/{main,dispatcher,core_api}.rs; chunk size default
25, circuit capacity 8/4/4 per chunk).

Within one host, "workers" are thread-pool provers sharing the card (or a
batch prover that pipelines host synthesis under device work); across
hosts, the same Dispatcher drives HTTP workers exactly like the reference.
The job/status/proof API follows core_api.rs.
"""

from __future__ import annotations

import concurrent.futures
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ..circuits.batch_mimc import (
    MAX_SHIELDED,
    MAX_TRANSFERS,
    MAX_WITHDRAWALS,
    BatchCircuitMiMC,
    ShieldedSlot,
    TransferSlot,
    WithdrawalSlot,
)
from ..hashes import mimc


@dataclass
class Chunk:
    index: int
    transfers: List[TransferSlot]
    withdrawals: List[WithdrawalSlot]
    shielded: List[ShieldedSlot]
    pre_state_root: int = 0
    post_state_root: int = 0
    pre_shielded_root: int = 0
    post_shielded_root: int = 0


@dataclass
class ChunkProof:
    chunk_index: int
    proof_bytes: bytes
    public_inputs: List[int]
    proving_time_ms: int
    public_witness: bytes = b""  # sunspot 236-byte witness blob


@dataclass
class ProofJob:
    job_id: str
    status: str = "queued"  # queued | running | done | failed | cancelled
    chunks: List[Chunk] = field(default_factory=list)
    proofs: List[ChunkProof] = field(default_factory=list)
    error: Optional[str] = None
    created_at: float = field(default_factory=time.time)


def mock_chunk_prover(chunk: Chunk, batch_id: int) -> ChunkProof:
    """Zero-proof worker with the reference's canned-proof shape
    (prover-worker/src/prover.rs:601-700)."""
    import hashlib

    digest = hashlib.blake2b(
        str((chunk.index, chunk.pre_state_root, chunk.post_state_root)).encode(),
        digest_size=32,
    ).digest()
    return ChunkProof(
        chunk_index=chunk.index,
        proof_bytes=digest + b"\x00" * (388 - 32),  # sunspot proof size
        public_inputs=[chunk.pre_state_root, chunk.post_state_root],
        proving_time_ms=1,
    )


class Dispatcher:
    """Slices batches into circuit-capacity chunks with chained roots."""

    def __init__(self, chunk_prover: Callable = mock_chunk_prover,
                 max_workers: int = 4, batch_prover: Callable = None):
        """chunk_prover: per-chunk callable (thread-pool fan-out, the
        reference's worker-fleet shape). batch_prover: optional
        (chunks, batch_id) -> [ChunkProof] that proves a whole job with
        its own pipelining -- the single-card runtime uses
        Groth16ChunkProver.prove_chunks here (host synthesis of chunk
        k+1 overlapped under chunk k's device scans); auto-wired when
        chunk_prover is a Groth16ChunkProver bound method."""
        self.chunk_prover = chunk_prover
        if batch_prover is None:
            owner = getattr(chunk_prover, "__self__", None)
            batch_prover = getattr(owner, "prove_chunks", None)
        self.batch_prover = batch_prover
        self.pool = concurrent.futures.ThreadPoolExecutor(max_workers)
        self.jobs: Dict[str, ProofJob] = {}
        self._lock = threading.Lock()

    # -- slicing -------------------------------------------------------------

    @staticmethod
    def slice_batch(transfers: List[TransferSlot],
                    withdrawals: List[WithdrawalSlot],
                    shielded: List[ShieldedSlot],
                    capacity=(MAX_TRANSFERS, MAX_WITHDRAWALS,
                              MAX_SHIELDED)) -> List[Chunk]:
        mt, mw, ms = capacity
        chunks = []
        ti = wi = si = 0
        index = 0
        while (ti < len(transfers) or wi < len(withdrawals)
               or si < len(shielded) or index == 0):
            chunk = Chunk(
                index=index,
                transfers=transfers[ti : ti + mt],
                withdrawals=withdrawals[wi : wi + mw],
                shielded=shielded[si : si + ms],
            )
            ti += mt
            wi += mw
            si += ms
            chunks.append(chunk)
            index += 1
            if ti >= len(transfers) and wi >= len(withdrawals) and si >= len(shielded):
                break
        return chunks

    @staticmethod
    def build_chunks_with_witness(builder, transfers, withdrawals, shielded,
                                  capacity=(MAX_TRANSFERS, MAX_WITHDRAWALS,
                                            MAX_SHIELDED),
                                  pre_shielded_root: int = 0) -> List[Chunk]:
        """Slice raw tx specs into chunks AND build the slot witnesses with
        intermediate Merkle paths in one pass (the reference splits this
        between core's build_witness_with_proofs and the coordinator's
        dispatcher; here the ChunkWitnessBuilder advances its SMT in the
        exact circuit order -- per chunk: transfers, then withdrawals, then
        shielded -- so every slot's path is taken against the right
        intermediate root and chunk pre/post roots chain for free).

        transfers: [(sender_pk, receiver_pk, amount)],
        withdrawals: [(sender_pk, l1_recipient, amount)],
        shielded: [output_commitment] for skip_verification mode, or
        ("full", position, spending_key, out_owner, out_value,
        out_blinding) for a full-verification spend of a note previously
        added with builder.add_note (full slots must lead their chunk and
        the caller passes pre_shielded_root=builder.shielded_root(), since
        the circuit proves inclusion against the chunk's pre root before
        the hash_2 fold updates it -- main.nr:283-321).
        """
        mt, mw, ms = capacity
        chunks: List[Chunk] = []
        ti = wi = si = 0
        index = 0
        shielded_root = pre_shielded_root
        from .chunk_witness import fold_shielded_root

        def s_slot(spec):
            if isinstance(spec, int):
                return builder.shielded_slot_skip(spec)
            kind, *args = spec
            if kind == "full":
                return builder.shielded_slot_full(*args)
            raise ValueError(f"unknown shielded spec kind {kind!r}")

        while (ti < len(transfers) or wi < len(withdrawals)
               or si < len(shielded) or index == 0):
            pre_state = builder.root()
            t_slots = [builder.transfer_slot(*t)
                       for t in transfers[ti:ti + mt]]
            w_slots = [builder.withdrawal_slot(*w)
                       for w in withdrawals[wi:wi + mw]]
            s_slots = [s_slot(spec) for spec in shielded[si:si + ms]]
            post_shielded = fold_shielded_root(shielded_root, s_slots)
            chunks.append(Chunk(
                index=index,
                transfers=t_slots,
                withdrawals=w_slots,
                shielded=s_slots,
                pre_state_root=pre_state,
                post_state_root=builder.root(),
                pre_shielded_root=shielded_root,
                post_shielded_root=post_shielded,
            ))
            shielded_root = post_shielded
            ti += mt
            wi += mw
            si += ms
            index += 1
            if (ti >= len(transfers) and wi >= len(withdrawals)
                    and si >= len(shielded)):
                break
        return chunks

    @staticmethod
    def chain_roots(chunks: List[Chunk], pre_state_root: int,
                    pre_shielded_root: int,
                    apply_chunk: Callable[[Chunk, int, int], tuple]):
        """Compute per-chunk pre/post roots by applying chunks in order.

        apply_chunk(chunk, state_root, shielded_root) -> (state', shielded').
        """
        state, shielded_root = pre_state_root, pre_shielded_root
        for chunk in chunks:
            chunk.pre_state_root = state
            chunk.pre_shielded_root = shielded_root
            state, shielded_root = apply_chunk(chunk, state, shielded_root)
            chunk.post_state_root = state
            chunk.post_shielded_root = shielded_root
        return state, shielded_root

    # -- jobs ----------------------------------------------------------------

    def submit_job(self, chunks: List[Chunk], batch_id: int) -> str:
        job_id = uuid.uuid4().hex[:16]
        job = ProofJob(job_id=job_id, chunks=chunks)
        with self._lock:
            self.jobs[job_id] = job

        def run():
            # all job-state writes under the dispatcher lock: expire() may
            # delete the job concurrently, and readers (status/proofs) must
            # never observe status == "done" before proofs is set
            with self._lock:
                if job.status == "cancelled":
                    return
                job.status = "running"
            try:
                if self.batch_prover is not None:
                    proofs = list(self.batch_prover(chunks, batch_id))
                else:
                    futures = [
                        self.pool.submit(self.chunk_prover, chunk, batch_id)
                        for chunk in chunks
                    ]
                    proofs = [f.result() for f in futures]
                proofs.sort(key=lambda p: p.chunk_index)
                with self._lock:
                    if job.status != "cancelled":
                        job.proofs = proofs
                        job.status = "done"
            except Exception as exc:  # worker failure -> job failed
                with self._lock:
                    if job.status != "cancelled":
                        job.status = "failed"
                        job.error = str(exc)

        threading.Thread(target=run, daemon=True).start()
        return job_id

    def status(self, job_id: str) -> Optional[str]:
        with self._lock:
            job = self.jobs.get(job_id)
            return job.status if job else None

    def proofs(self, job_id: str) -> Optional[List[ChunkProof]]:
        with self._lock:
            job = self.jobs.get(job_id)
            if job is None or job.status != "done":
                return None
            return job.proofs

    def cancel(self, job_id: str) -> bool:
        with self._lock:
            job = self.jobs.get(job_id)
            if job and job.status in ("queued", "running"):
                job.status = "cancelled"
                return True
            return False

    def expire(self, max_age_secs: float = 3600.0):
        now = time.time()
        with self._lock:
            stale = [jid for jid, j in self.jobs.items()
                     if now - j.created_at > max_age_secs]
            for jid in stale:
                del self.jobs[jid]
        return len(stale)
