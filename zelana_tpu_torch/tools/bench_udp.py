"""Zephyr UDP ingest throughput (core/examples/bench_throughput.rs parity).

    python -m zelana_tpu_torch.tools.bench_udp [--count N] [--device D]

Boots a pipeline + Zephyr UDP server in-process, blasts N encrypted
transfer packets from the client, and prints the measured client-side TPS
(the reference's bench prints the same measure for a 10,000-tx blast).
The pipeline's prover is a Groth16Prover on the committed L2 key and on
`--device` ("cuda" by default); no batch is sealed, so it never proves."""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="bench_udp")
    parser.add_argument("--count", type=int, default=2_000)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    import os

    from ..groth16.keys import ProvingKey
    from ..sdk.zephyr import ZephyrClient, ZephyrServer
    from ..sequencer import crypto
    from ..sequencer.batch import BatchConfig
    from ..sequencer.pipeline import (
        PipelineConfig,
        PipelineOrchestrator,
    )
    from ..sequencer.prover_service import Groth16Prover
    from ..sequencer.transactions import Deposit, Transfer

    seed = b"\x01" * 32
    _, _, alice = crypto.secret_to_keypair(seed)
    bob = b"\x02" * 32
    key = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "artifacts", "l2_dummy_pk.npz")
    orch = PipelineOrchestrator(
        config=PipelineConfig(batch=BatchConfig(
            max_txs=10**9, max_age_secs=3600)),
        prover=Groth16Prover(ProvingKey.load_npz(key), args.device),
        dev_mode=False,
    )
    orch.submit(Deposit(to=alice, amount=args.count * 2, l1_seq=1))

    def handler(req):
        tx = Transfer(
            signer_pubkey=bytes.fromhex(req["from"]),
            to=bytes.fromhex(req["to"]),
            amount=int(req["amount"]),
            nonce=int(req["nonce"]),
            signature=bytes.fromhex(req.get("signature", "")),
        )
        res = orch.submit(tx)
        return {"accepted": res.accepted, "error": res.error}

    server = ZephyrServer(handler, port=0).start()
    client = ZephyrClient(("127.0.0.1", server.port))
    client.handshake()

    accepted = 0
    t0 = time.time()
    for i in range(args.count):
        tx = Transfer(signer_pubkey=alice, to=bob, amount=1, nonce=i)
        tx.signature = crypto.sign(seed, tx.signing_message())
        resp = client.request({
            "from": alice.hex(), "to": bob.hex(), "amount": 1,
            "nonce": i, "signature": tx.signature.hex(),
        })
        accepted += 1 if resp.get("accepted") else 0
    dt = time.time() - t0
    print(f"udp ingest: {accepted}/{args.count} accepted in {dt:.2f}s "
          f"-> {accepted / dt:.0f} TPS (encrypted round-trips)")
    server.stop()
    return 0 if accepted == args.count else 1


if __name__ == "__main__":
    sys.exit(main())
