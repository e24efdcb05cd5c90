"""A prover node working a backlog of the coordinator's batches through
Groth16ChunkProver.prove_chunks: chunk k+1's host stage beside chunk k's
kernels, one batch after another, each with a fresh batch id.

Traffic parameters (traffic/<name>.json): "chunks" a batch (the last one
half filled, frozen.production_spec), "draw" (the ranges the seed draws
funds, amounts and the note from). Every proof's public inputs are
checked, and one proof of every chunk index (each position of the
pipeline), from a batch drawn from the seed, is re-derived whole.
Configuration: "capacity", "tree_depth"; the key is made on the device
from --seed.
"""

from __future__ import annotations

import random
import sys

from portbench import frozen
from portbench.harness import Verdict
from portbench.reference import groth16 as RG
from portbench.reference.chunk_batch import Batch, circuit_input, \
    public_values
from portbench.reference.circuits import chunk_circuit
from portbench.reference.cs import ConstraintSystem

RATE_METRIC = "chunk_proofs_per_s"


def program_chunks(spec: dict, cap, depth: int) -> list:
    """The coordinator's chunks of a batch spec, with their witnesses."""
    from zelana_tpu_torch.runtime.chunk_witness import ChunkWitnessBuilder
    from zelana_tpu_torch.runtime.coordinator import Dispatcher

    builder = ChunkWitnessBuilder(depth)
    for pk, balance in spec["funds"]:
        builder.fund(pk, balance)
    for sk, value, blinding in spec["notes"]:
        builder.add_note(spending_key=sk, value=value, blinding=blinding)
    return Dispatcher.build_chunks_with_witness(
        builder, spec["transfers"], spec["withdrawals"],
        [tuple(s) if isinstance(s, list) else s for s in spec["shielded"]],
        capacity=cap, pre_shielded_root=builder.shielded_root())


class Session:
    rate_metric = RATE_METRIC

    def __init__(self, ctx):
        cfg, tr = ctx.config, ctx.traffic
        self.cap, self.depth = tuple(cfg["capacity"]), cfg["tree_depth"]
        self.seed = ctx.seed
        rng = random.Random(ctx.seed)
        self.spec = frozen.production_spec(self.cap, tr["chunks"], rng,
                                           tr["draw"], self.depth)
        from zelana_tpu_torch.runtime.chunk_prover import Groth16ChunkProver

        self.prover = Groth16ChunkProver.setup(
            self.cap, self.depth, seed=ctx.seed, device=ctx.device)
        self.pk = self.prover.pk
        self.chunks = program_chunks(self.spec, self.cap, self.depth)
        self.next_id = rng.randrange(1, 1 << 40)
        self.batches = []  # batch ids the window attempted
        # one prove at the cell's shapes (the NTT plan, the query pools)
        self.prover.prove_chunks(self.chunks[:1], self.next_id)
        self.next_id += 1

    def run_unit(self) -> list:
        bid = self.next_id
        self.next_id += 1
        self.batches.append(bid)
        proofs = self.prover.prove_chunks(self.chunks, bid)
        print(f"batch {bid}: chunk ms {[cp.proving_time_ms for cp in proofs]}",
              file=sys.stderr, flush=True)
        return [(bid, cp) for cp in proofs]

    def free(self) -> None:
        self.prover = self.pk = None
        import torch

        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def check(self, outputs) -> Verdict:
        """Every batch whole (one proof a chunk), every proof's public
        inputs (the chained roots and the accumulators) equal to the
        reference's, and one proof of every chunk index, its batch drawn
        from the seed, byte-equal to the proof the reference works out."""
        ref = Batch(self.spec, self.cap, self.depth)
        n = len(ref.chunks)
        got = {}
        for bid, cp in outputs:
            got.setdefault(bid, []).append(cp)
        missing = sum(
            n - len({cp.chunk_index for cp in got.get(bid, [])
                     if 0 <= cp.chunk_index < n})
            for bid in self.batches)
        bad_public = set()
        for k, (bid, cp) in enumerate(outputs):
            want = public_values(ref.chunks[cp.chunk_index], bid) \
                if 0 <= cp.chunk_index < n else None
            if (want is None or [int(v) for v in cp.public_inputs] != want
                    or cp.public_witness != witness_bytes(want)):
                bad_public.add(k)
        sample = sample_outputs(outputs, n, random.Random(self.seed ^ 0x5EED))
        key, bad_proof = None, set()
        for k in sample:
            bid, cp = outputs[k]
            cs = ConstraintSystem()
            chunk_circuit(cs, circuit_input(ref.chunks[cp.chunk_index], bid))
            if key is None:
                key = RG.Key(self.seed, cs.num_constraints + len(cs.inputs))
            want = (RG.solana_bytes(RG.proof_points(key, cs, bid))
                    + bytes(4) + bytes(128))
            if cp.proof_bytes != want:
                bad_proof.add(k)
        return Verdict(
            attempted=n * len(self.batches),
            failed=missing + len(bad_public | bad_proof),
            numbers=[("missing_proofs", missing, 0),
                     ("public_inputs_differing", len(bad_public), 0),
                     ("proofs_differing", len(bad_proof), 0)],
            rederived=len(sample))


def witness_bytes(values) -> bytes:
    """The sunspot public witness: count, 8 zero bytes, 32-byte big-endian
    values."""
    return (len(values).to_bytes(4, "big") + bytes(8)
            + b"".join(int(v).to_bytes(32, "big") for v in values))


def sample_outputs(outputs, n: int, rng: random.Random) -> list:
    """An index of outputs for every chunk index below n that some output
    has: one of that chunk's proofs, drawn with rng."""
    pick = []
    for want in range(n):
        cands = [i for i, (_b, cp) in enumerate(outputs)
                 if cp.chunk_index == want]
        if cands:
            pick.append(rng.choice(cands))
    return sorted(pick)


def setup(ctx) -> Session:
    return Session(ctx)

