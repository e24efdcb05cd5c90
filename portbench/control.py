"""The control of the comparison that decides `correct`: the reference put
in the program's place, with one guarantee of the configuration broken.

    python3 portbench/control.py --workload chunk844_d32.backlog \
        --seeds 11,12,13 --seconds 1 --fault other_batch

runs the cell with the program's prover replaced by one that returns the
proofs the reference works out, a fault planted (`other_batch`: every
proof made with the randomness of the next batch id, a proof that still
verifies but is not the deterministic proof of its batch; `proof_byte`: a
byte of every proof flipped; `public_input`: the last public input of a
batch's last proof altered; `half_batch`: half of each batch left out),
and prints each seed's numbers beside their limits. With no fault the
stand-in's runs are correct. The benchmark's own runs never run it; the
CPU tests use the stand-in at a size a test can hold.
"""

from __future__ import annotations

import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.reference import groth16 as RG  # noqa: E402
from portbench.reference.chunk_batch import public_values  # noqa: E402
from portbench.reference.circuits import chunk_circuit  # noqa: E402
from portbench.reference.cs import ConstraintSystem  # noqa: E402


@dataclasses.dataclass
class ChunkProof:
    chunk_index: int
    proof_bytes: bytes
    public_inputs: list
    proving_time_ms: int = 0
    public_witness: bytes = b""


def ref_chunk(chunk, cap, depth) -> dict:
    """A program Chunk as the reference's chunk dict."""
    from portbench.reference import chunk_batch as CB

    pads = (CB._transfer_pad, CB._withdrawal_pad, CB._shielded_pad)
    slots = []
    for kind, pad, n in zip(("transfers", "withdrawals", "shielded"), pads,
                            cap):
        got = [dataclasses.asdict(s) for s in getattr(chunk, kind)]
        slots.append(got + [pad(depth)] * (n - len(got)))
    return {"index": chunk.index, "transfers": slots[0],
            "withdrawals": slots[1], "shielded": slots[2],
            "counts": tuple(len(getattr(chunk, k)) for k in (
                "transfers", "withdrawals", "shielded")),
            "roots": (chunk.pre_state_root, chunk.post_state_root,
                      chunk.pre_shielded_root, chunk.post_shielded_root)}


class ReferenceChunkProver:
    """Groth16ChunkProver's setup / prove_chunks, by the reference."""

    # "half_batch" | "proof_byte" | "public_input" | "other_batch"
    fault = None

    def __init__(self, cap, depth, seed):
        self.cap, self.depth, self.seed = cap, depth, seed
        self.pk, self.device, self.key = None, "cpu", None

    @classmethod
    def setup(cls, cap, depth, seed=0, device="cpu"):
        return cls(cap, depth, seed)

    def prove_chunks(self, chunks, batch_id):
        from portbench.drivers.chunk_backlog import witness_bytes

        out = []
        for chunk in chunks:
            ch = ref_chunk(chunk, self.cap, self.depth)
            values = public_values(ch, batch_id)
            cs = ConstraintSystem()
            chunk_circuit(cs, {**ch, "public": values})
            if self.key is None:
                self.key = RG.Key(self.seed,
                                  cs.num_constraints + len(cs.inputs))
            bid = batch_id + (self.fault == "other_batch")
            proof = (RG.solana_bytes(RG.proof_points(self.key, cs, bid))
                     + bytes(132))
            out.append(ChunkProof(chunk.index, proof, values, 0,
                                  witness_bytes(values)))
        if self.fault == "half_batch":
            out = out[:len(out) // 2]
        elif self.fault == "proof_byte":
            for cp in out:
                cp.proof_bytes = bytes([cp.proof_bytes[0] ^ 1]) \
                    + cp.proof_bytes[1:]
        elif self.fault == "public_input":
            out[-1].public_inputs = out[-1].public_inputs[:-1] + [
                out[-1].public_inputs[-1] + 1]
        return out


def main(argv=None) -> int:
    import argparse
    import json
    import time

    from portbench import harness as H
    from portbench import run as R
    from zelana_tpu_torch.runtime import chunk_prover

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--fault", default="other_batch")
    args = ap.parse_args(argv)
    chunk_prover.Groth16ChunkProver = ReferenceChunkProver
    ReferenceChunkProver.fault = None if args.fault == "none" else args.fault
    cell = H.find_cell(H.load_json(os.path.join(ROOT, "BENCHMARK.json")),
                       args.workload)
    for seed in map(int, args.seeds.split(",")):
        t0 = time.time()
        out = R.run_cell(cell, seed, args.seconds, False, device="cpu",
                         t_start=t0)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "fault": args.fault, "correct": out["correct"],
                          "attempted": out["attempted"],
                          "checks": out["checks"],
                          "seconds": time.time() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
