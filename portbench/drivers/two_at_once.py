"""A prover worker serving two-chunk jobs as runtime/worker.py does: the
job's two chunks proved at once on two threads through
Groth16ChunkProver.prove_chunk (unpipelined, their kernels on the default
stream), one job after another, each with a fresh batch id.

Traffic parameters (traffic/<name>.json): "chunks" a job (the last one
half filled, frozen.production_spec), "draw" (the ranges the seed draws
funds, amounts and the note from). The set-up, the key and the check are
chunk_backlog's: every proof's public inputs are checked, and one proof of
every chunk index, from a job drawn from the seed, is re-derived whole.
"""

from __future__ import annotations

import concurrent.futures as cf
import sys

from portbench.drivers.chunk_backlog import Session as Backlog


class Session(Backlog):
    def run_unit(self) -> list:
        bid = self.next_id
        self.next_id += 1
        self.batches.append(bid)
        with cf.ThreadPoolExecutor(len(self.chunks)) as ex:
            futures = [ex.submit(self.prover.prove_chunk, chunk, bid)
                       for chunk in self.chunks]
            proofs = [f.result() for f in futures]
        print(f"job {bid}: chunk ms {[cp.proving_time_ms for cp in proofs]}",
              file=sys.stderr, flush=True)
        return [(bid, cp) for cp in proofs]


def setup(ctx) -> Session:
    return Session(ctx)
