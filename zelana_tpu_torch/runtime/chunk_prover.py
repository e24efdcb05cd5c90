"""Groth16 chunk prover for the distributed coordinator, on the card.

Proves the fixed-shape BatchCircuitMiMC: because the slot layout is fixed,
ONE proving key serves every chunk, the property the reference's worker
fleet relies on (one compiled circuit for all chunks). Synthesis is native
(r1cs/native_synth.py); keygen and proves run through the port's kernels.

Proof wire format ("sunspot-shaped", settler.rs:343-470):
- proof: 388 bytes = 256-byte Groth16 proof in the deployed-verifier
  encoding (pre-negated pi_a, big-endian, EIP-197 G2 order,
  prover_service.proof_to_solana_bytes) + 4-byte big-endian commitment
  count (0) + 128 reserved zero bytes, the size of
  NoirProofData::PROOF_SIZE so the settler routes it down the sunspot path.
- public witness: 236 bytes = 4-byte big-endian input count (7) + 8 zero
  bytes + 7 x 32-byte big-endian field elements
  (prover-worker prover.rs:574-597 parse_public_witness layout).
"""

from __future__ import annotations

import concurrent.futures as cf
import time
from typing import List

from ..circuits.batch_mimc import BatchCircuitMiMC
from ..device import resolve
from ..groth16.keys import Proof, ProvingKey
from ..parallel import distributed as D
from ..trace import carry, span
from .chunk_witness import chunk_accumulators
from .coordinator import Chunk, ChunkProof

PROOF_SIZE = 388
PUBLIC_WITNESS_SIZE = 236


def sunspot_proof_bytes(proof: Proof) -> bytes:
    from ..sequencer.prover_service import proof_to_solana_bytes

    core = proof_to_solana_bytes(proof)  # 256B, BE, negated pi_a
    return core + (0).to_bytes(4, "big") + b"\x00" * 128


def sunspot_public_witness(values: List[int]) -> bytes:
    out = len(values).to_bytes(4, "big") + b"\x00" * 8
    for v in values:
        out += int(v).to_bytes(32, "big")
    assert len(out) == 4 + 8 + 32 * len(values)
    return out


def parse_public_witness(data: bytes) -> List[int]:
    """prover-worker prover.rs:574-597."""
    if len(data) < 12:
        return []
    count = int.from_bytes(data[:4], "big")
    return [
        int.from_bytes(data[12 + 32 * i:12 + 32 * (i + 1)], "big")
        for i in range(count)
        if 12 + 32 * (i + 1) <= len(data)
    ]


def _public_values(circuit, batch_id: int) -> list:
    return [circuit.pre_state_root, circuit.post_state_root,
            circuit.pre_shielded_root, circuit.post_shielded_root,
            circuit.withdrawal_root, circuit.batch_hash, batch_id]


class Groth16ChunkProver:
    """One proving key, any chunk of the fixed capacity, on one device or
    over a mesh (a parallel.distributed.Mesh; with none given, the
    initialized default group when it has more than one rank): every rank
    proves each chunk with the MSMs sharded and returns the same proof."""

    def __init__(self, pk: ProvingKey, capacity=(8, 4, 4),
                 tree_depth: int = 32, device="cuda", mesh=None):
        self.pk = pk
        self.capacity = capacity
        self.tree_depth = tree_depth
        self.device, self.mesh = D.placement(device, mesh)

    @classmethod
    def setup(cls, capacity=(8, 4, 4), tree_depth: int = 32, seed: int = 0,
              device="cuda") -> "Groth16ChunkProver":
        """Keygen on the empty (all-invalid-slot) circuit: the dummy is
        satisfiable because every gated constraint passes with zero
        witnesses and the accumulators finalize over zero counts."""
        from ..groth16.setup import keygen_synthesized
        from ..r1cs.native_synth import synthesize_chunk

        dev = resolve(device)
        with span("keygen.synthesize"):
            system = synthesize_chunk(cls.dummy_circuit(capacity, tree_depth))
        return cls(keygen_synthesized(system, seed=seed, device=dev),
                   capacity, tree_depth, dev)

    @staticmethod
    def dummy_circuit(capacity=(8, 4, 4), tree_depth: int = 32):
        wd_root, batch_hash = chunk_accumulators(0, [], [], [])
        return BatchCircuitMiMC(
            pre_state_root=0, post_state_root=0,
            pre_shielded_root=0, post_shielded_root=0,
            withdrawal_root=wd_root, batch_hash=batch_hash, batch_id=0,
            max_transfers=capacity[0], max_withdrawals=capacity[1],
            max_shielded=capacity[2], tree_depth=tree_depth,
        )

    def build_circuit(self, chunk: Chunk, batch_id: int) -> BatchCircuitMiMC:
        wd_root, batch_hash = chunk_accumulators(
            batch_id, chunk.transfers, chunk.withdrawals, chunk.shielded)
        return BatchCircuitMiMC(
            pre_state_root=chunk.pre_state_root,
            post_state_root=chunk.post_state_root,
            pre_shielded_root=chunk.pre_shielded_root,
            post_shielded_root=chunk.post_shielded_root,
            withdrawal_root=wd_root,
            batch_hash=batch_hash,
            batch_id=batch_id,
            transfers=chunk.transfers,
            withdrawals=chunk.withdrawals,
            shielded=chunk.shielded,
            num_transfers=sum(1 for t in chunk.transfers if t.is_valid),
            num_withdrawals=sum(1 for w in chunk.withdrawals if w.is_valid),
            num_shielded=sum(1 for s in chunk.shielded if s.is_valid),
            max_transfers=self.capacity[0],
            max_withdrawals=self.capacity[1],
            max_shielded=self.capacity[2],
            tree_depth=self.tree_depth,
        )

    def _chunk_proof(self, chunk: Chunk, circuit, proof: Proof,
                     batch_id: int, start: float) -> ChunkProof:
        values = _public_values(circuit, batch_id)
        return ChunkProof(
            chunk_index=chunk.index,
            proof_bytes=sunspot_proof_bytes(proof),
            public_inputs=values,
            proving_time_ms=int((time.time() - start) * 1000),
            public_witness=sunspot_public_witness(values),
        )

    def prove_chunk(self, chunk: Chunk, batch_id: int) -> ChunkProof:
        from ..groth16.prove import prove_synthesized
        from ..r1cs.native_synth import synthesize_chunk

        start = time.time()
        with span("chunk.prove", request=f"{batch_id}/{chunk.index}"):
            with span("chunk.build_circuit"):
                circuit = self.build_circuit(chunk, batch_id)
            with span("chunk.synthesize"):
                system = synthesize_chunk(circuit)
            proof = prove_synthesized(self.pk, system, batch_id=batch_id,
                                      device=self.device, mesh=self.mesh)
            return self._chunk_proof(chunk, circuit, proof, batch_id, start)

    def _synth_chunk(self, chunk: Chunk, batch_id: int):
        """Host stage of one chunk, run on a worker thread: circuit build,
        native synthesis, satisfaction check, the z digits and segment
        schedules, and the uploads of the witness-map inputs and schedules
        (on the upload stream, see ops/staging.py) -- everything the prove
        needs that does not depend on the previous chunk's device work."""
        from ..groth16 import prove as P
        from ..ops import msm_scan as MSM
        from ..ops import staging
        from ..r1cs.native_synth import synthesize_chunk

        dev = self.device
        with span("chunk.host_stage"):
            with span("chunk.build_circuit"):
                circuit = self.build_circuit(chunk, batch_id)
            with span("chunk.synthesize"):
                system = synthesize_chunk(circuit)
            with span("chunk.check"):
                bad = system.check()
            if bad != -1:
                raise ValueError(
                    f"constraint {bad} unsatisfied; witness invalid")
            with span("chunk.z_digits"):
                digits_z = MSM.scalar_digits(system.z)
            with span("chunk.z_schedules") as sp:
                if self.mesh is None:
                    segs_z = MSM.build_segment_schedules(digits_z)
                else:  # this rank's shard of the a, b1, l and b2 pools
                    from ..parallel.sharded import shard_schedules

                    segs_z = shard_schedules(digits_z, digits_z.shape[1],
                                             self.mesh)
                sp.counts.update(MSM.schedule_counts(segs_z))
            pre = {"digits_z": digits_z, "segs_z": segs_z}
            with staging.side_stream(dev):
                pre["wm"] = P.witness_map_stage_native(system, dev)
                MSM.upload_segment_schedules(segs_z, dev)
                pre["uploads"] = staging.hand_over(
                    pre["wm"].words + [t for seg in segs_z
                                       for t in seg["dev"].values()], dev)
            return circuit, system, pre

    def prove_chunks(self, chunks: List[Chunk],
                     batch_id: int) -> List[ChunkProof]:
        """Pipelined batch prove: chunk k+1's host stage (synthesis,
        schedules, uploads) runs on a worker thread while chunk k's kernels
        run. Same chained-root semantics as the reference's worker-pool
        fan-out (prover-coordinator/src/dispatcher.rs:34-62)."""
        from ..groth16.prove import prove_synthesized

        out: List[ChunkProof] = []
        with span("chunk.batch", request=str(batch_id)) as batch, \
                cf.ThreadPoolExecutor(1) as ex:
            def host_stage(chunk):
                return ex.submit(carry(self._synth_chunk, batch,
                                       f"{batch_id}/{chunk.index}"),
                                 chunk, batch_id)

            nxt = host_stage(chunks[0])
            for i, chunk in enumerate(chunks):
                start = time.time()
                with span("chunk.prove", request=f"{batch_id}/{chunk.index}"):
                    with span("chunk.wait_host_stage"):
                        circuit, system, pre = nxt.result()
                    if i + 1 < len(chunks):
                        nxt = host_stage(chunks[i + 1])
                    # the worker ran the satisfaction check
                    proof = prove_synthesized(
                        self.pk, system, batch_id=batch_id, check=False,
                        precomputed=pre, device=self.device, mesh=self.mesh)
                    out.append(self._chunk_proof(chunk, circuit, proof,
                                                 batch_id, start))
        return out

    def verify_chunk(self, cp: ChunkProof) -> bool:
        from ..groth16.verify import verify as groth16_verify
        from ..sequencer.prover_service import solana_bytes_to_proof

        if len(cp.proof_bytes) != PROOF_SIZE:
            return False
        proof = solana_bytes_to_proof(cp.proof_bytes[:256])
        values = (cp.public_inputs if cp.public_inputs
                  else parse_public_witness(cp.public_witness))
        return groth16_verify(self.pk.vk, proof, list(values))

    def as_chunk_prover(self):
        """The Dispatcher's chunk_prover callable."""
        return self.prove_chunk
