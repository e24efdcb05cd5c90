"""zelana-tpu command line on the card (mirror of cli/ + the forge service
binaries), over the port's modules.

    python -m zelana_tpu_torch.cli dev         # local stack: pipeline + HTTP (+UDP)
    python -m zelana_tpu_torch.cli test        # self-contained e2e (--zk for CPI)
    python -m zelana_tpu_torch.cli deploy      # bridge PDAs + chunked VK store
    python -m zelana_tpu_torch.cli airdrop     # dev faucet vs a running sequencer
    python -m zelana_tpu_torch.cli genkey      # dual-key wallet file
    python -m zelana_tpu_torch.cli keygen      # Groth16 circuit-specific setup
    python -m zelana_tpu_torch.cli prove       # prove a demo batch end to end
    python -m zelana_tpu_torch.cli verify      # verify a proof file
    python -m zelana_tpu_torch.cli worker      # chunk-proving worker service
    python -m zelana_tpu_torch.cli node        # blind MPC prover node
    python -m zelana_tpu_torch.cli explorer    # live store web explorer

The subcommands take the arguments and print the lines of the JAX
package's CLI, and write the same files. One option comes before the
subcommand: `--device` ("cuda" by default) is the device of every prover,
keygen and chunk prover a command builds. With no card, `keygen`, `prove`,
`worker`, `dev` under a Groth16 config and `test --zk` raise unless given
`--device cpu`; the other commands touch no device. On shutdown `dev` also
prints the state of the batch its last seal made.

`dev` builds its prover with `build_prover_from_config`, which proves with
Groth16 or raises: the port has no mock prover. The batches of `test` and
tools/e2e.py mix a deposit, a transfer and a withdrawal, a shape no key in
the repo fits, so their pipeline proves with `HashProveLeg`, the JAX
package's mock proof without its sleep, and settles through the bridge
model; `test --zk` proves for real on `--device`.
"""

from __future__ import annotations

import argparse
import base64
import hashlib
import json
import sys
import time


class HashProveLeg:
    """The prove leg of `test` and tools/e2e.py: the JAX package's
    MockProver proof (blake2b over the public inputs, padded to 256 bytes)
    with no sleep. It stands for the JAX `test`'s mock prove leg as
    `NoVerifySettler` stands for its settle leg; nothing else constructs
    it."""

    def prove(self, inputs, witness):
        from .sequencer.prover_service import BatchProof

        h = hashlib.blake2b(digest_size=32)
        for root in (inputs.pre_state_root, inputs.post_state_root,
                     inputs.pre_shielded_root, inputs.post_shielded_root,
                     inputs.withdrawal_root, inputs.batch_hash):
            h.update(root)
        h.update(inputs.batch_id.to_bytes(8, "little"))
        return BatchProof(inputs, h.digest() + b"\x00" * 224, 0)


def cmd_dev(args):
    from .sequencer.api import start_api
    from .sequencer.config import ZelanaConfig
    from .sequencer.pipeline import (
        PipelineConfig, PipelineOrchestrator, PipelineService)
    from .sequencer.batch import BatchConfig

    from .sequencer.prover_service import build_prover_from_config

    cfg = ZelanaConfig.load(args.config)
    try:
        prover = build_prover_from_config(cfg, args.device)
    except ValueError as exc:
        print(f"dev: {exc}", file=sys.stderr)
        raise
    print(f"prover: {type(prover).__name__} (mode={cfg.prover_mode})")
    orch = PipelineOrchestrator(
        config=PipelineConfig(
            batch=BatchConfig(
                max_txs=cfg.batch_max_txs,
                max_age_secs=cfg.batch_max_age_secs,
                max_shielded=cfg.batch_max_shielded,
            )
        ),
        prover=prover,
        dev_mode=cfg.dev_mode,
    )
    service = PipelineService(orch).start()
    server, port = start_api(orch, port=cfg.http_port if not args.ephemeral else 0)
    print(f"zelana-tpu sequencer: http://127.0.0.1:{port}")
    udp = None
    if cfg.udp_enabled:
        from .sdk.zephyr import ZephyrServer

        def udp_handler(req):
            from .sequencer.transactions import Transfer

            tx = Transfer(
                signer_pubkey=bytes.fromhex(req["from"]),
                to=bytes.fromhex(req["to"]),
                amount=int(req["amount"]),
                nonce=int(req["nonce"]),
                signature=bytes.fromhex(req.get("signature", "")),
            )
            res = orch.submit(tx)
            return {"accepted": res.accepted, "error": res.error}

        udp = ZephyrServer(udp_handler, port=cfg.udp_port).start()
        print(f"zephyr udp: 127.0.0.1:{udp.port}")
    try:
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        print("shutting down (sealing pending batch)...")
        service.stop()
        server.shutdown()
        if udp:
            udp.stop()
        if orch.batches.sealed:  # what the shutdown seal came to
            last = orch.batches.sealed[-1]
            print(f"last batch {last.id}: {last.state.name}"
                  + (f" ({last.error})" if last.error else ""))


def demo_circuit():
    """`prove`'s batch: L2BlockCircuit.dummy() with its roots folded for
    the circuit's own batch_id (0)."""
    from .circuits.l2_block import (
        L2BlockCircuit, apply_transfers, compute_batch_hash,
        compute_state_root, compute_withdrawal_root)

    circuit = L2BlockCircuit.dummy()
    final = apply_transfers(circuit.initial_accounts, circuit.transactions)
    circuit.pre_state_root = compute_state_root(circuit.batch_id,
                                                circuit.initial_accounts)
    circuit.post_state_root = compute_state_root(circuit.batch_id, final)
    circuit.withdrawal_root = compute_withdrawal_root(circuit.withdrawals)
    circuit.batch_hash = compute_batch_hash(circuit.batch_id,
                                            circuit.transactions)
    return circuit


def cmd_keygen(args):
    from .circuits.l2_block import L2BlockCircuit
    from .groth16.setup import keygen

    print("Groth16 circuit-specific setup on L2BlockCircuit.dummy() ...")
    start = time.time()
    pk = keygen(L2BlockCircuit.dummy(), seed=args.seed, device=args.device)
    print(f"setup done in {time.time() - start:.1f}s")
    with open(args.pk_out, "wb") as f:
        f.write(pk.serialize_compressed())
    with open(args.vk_out, "wb") as f:
        f.write(pk.vk.serialize_compressed())
    vk_hash = hashlib.blake2b(pk.vk.serialize_compressed(),
                              digest_size=32).hexdigest()
    print(f"pk -> {args.pk_out}\nvk -> {args.vk_out}\nvk hash: {vk_hash}")


def cmd_prove(args):
    from .device import resolve
    from .groth16.keys import ProvingKey
    from .groth16.prove import prove, public_inputs_of
    from .groth16.verify import verify

    device = resolve(args.device)  # before the key's host decoding
    with open(args.pk, "rb") as f:
        pk = ProvingKey.deserialize_compressed(f.read())
    circuit = demo_circuit()
    start = time.time()
    proof = prove(pk, circuit, batch_id=args.batch_id, device=device)
    elapsed = time.time() - start
    ok = verify(pk.vk, proof, public_inputs_of(circuit))
    blob = base64.b64encode(proof.serialize_compressed()).decode()
    with open(args.out, "w") as f:
        json.dump({"proof": blob}, f, indent=2)
    print(f"proved in {elapsed:.1f}s, verified: {ok}, -> {args.out}")


def cmd_verify(args):
    from .groth16.keys import Proof, VerifyingKey
    from .curves import g1, g2

    with open(args.proof) as f:
        blob = base64.b64decode(json.load(f)["proof"])
    proof = Proof.deserialize_compressed(blob)
    checks = {
        "a on curve+subgroup": g1.in_subgroup(proof.a),
        "b on curve+subgroup": g2.in_subgroup(proof.b),
        "c on curve+subgroup": g1.in_subgroup(proof.c),
    }
    for name, ok in checks.items():
        print(f"  {name}: {ok}")
    if args.vk and args.inputs:
        with open(args.vk) as f:
            vk = VerifyingKey.deserialize_compressed(
                base64.b64decode(json.load(f)["verifying_key"]))
        inputs = [int(x, 0) for x in args.inputs.split(",")]
        from .groth16.verify import verify

        print(f"  pairing check: {verify(vk, proof, inputs)}")


def cmd_worker(args):
    """Chunk-proving worker (forge prover-worker main.rs): keygen the
    fixed-capacity chunk circuit once on `--device`, then serve /prove."""
    from .runtime.chunk_prover import Groth16ChunkProver
    from .runtime.worker import start_worker

    cap = tuple(int(x) for x in args.capacity.split("/"))
    print(f"keygen for capacity {cap}, depth {args.depth}...")
    prover = Groth16ChunkProver.setup(cap, args.depth, device=args.device)
    server, port = start_worker(prover, port=args.port)
    print(f"chunk worker: http://127.0.0.1:{port}")
    try:
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        server.shutdown()


def cmd_node(args):
    """Blind MPC prover node (forge prover-node main.rs)."""
    from .runtime.prover_node import start_prover_node

    server, port, _ = start_prover_node(args.node_id, port=args.port)
    print(f"prover node {args.node_id}: http://127.0.0.1:{port}")
    try:
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        server.shutdown()


def cmd_test(args):
    """Self-contained e2e test (cli `zelana test`, cli/src/main.rs:33-39 +
    dev.rs run_tests): boots an in-process stack -- bridge program model,
    deposit indexer, pipeline, settler -- and drives the full L1->L2->L1
    loop, printing one PASS/FAIL line per step."""
    from .sequencer import crypto
    from .sequencer.batch import BatchConfig
    from .sequencer.bridge import DepositIndexer
    from .sequencer.bridge_program import (
        AccountMeta, BridgeSVM, Instruction, BRIDGE_PROGRAM_ID,
        derive_config_pda, derive_vault_pda, derive_deposit_receipt_pda)
    from .sequencer.pipeline import (
        PipelineConfig, PipelineOrchestrator)
    from .sequencer.settler import BridgeProgramSettler, MockSettler
    from .sequencer.transactions import Transfer, Withdraw

    if args.zk:
        from .device import resolve

        resolve(args.device)  # before the e2e leg, not after it
    domain = b"\x11" * 32
    sequencer_auth = b"\x22" * 32
    svm = BridgeSVM()
    config_pda, _ = derive_config_pda(domain)
    vault_pda, _ = derive_vault_pda(domain)
    svm.process(Instruction(
        program_id=BRIDGE_PROGRAM_ID,
        accounts=[
            AccountMeta(sequencer_auth, is_signer=True, is_writable=True),
            AccountMeta(config_pda, is_writable=True),
            AccountMeta(vault_pda, is_writable=True),
            AccountMeta(b"\x00" * 32),
        ],
        data=bytes([0]) + sequencer_auth + domain,
    ))

    failures = 0

    def check(name, ok):
        nonlocal failures
        print(f"  [{'PASS' if ok else 'FAIL'}] {name}")
        failures += 0 if ok else 1

    alice_seed, bob_seed = b"\x01" * 32, b"\x02" * 32
    _, _, alice = crypto.secret_to_keypair(alice_seed)
    _, _, bob = crypto.secret_to_keypair(bob_seed)
    alice_l1 = b"\x77" * 32
    svm.airdrop(alice, 10_000)

    class NoVerifySettler(BridgeProgramSettler):
        # hash prove leg; real withdrawal-execution leg (the ZK CPI leg
        # runs separately below under --zk)
        def submit(self, proof):
            return MockSettler().submit(proof)

    settler = NoVerifySettler(svm, domain, sequencer_auth)
    orch = PipelineOrchestrator(
        config=PipelineConfig(batch=BatchConfig(max_age_secs=3600)),
        prover=HashProveLeg(), settler=settler, dev_mode=False)

    # L1 deposit -> vault + ZE_DEPOSIT log
    receipt_pda, _ = derive_deposit_receipt_pda(domain, alice, 1)
    svm.process(Instruction(
        program_id=BRIDGE_PROGRAM_ID,
        accounts=[
            AccountMeta(alice, is_signer=True, is_writable=True),
            AccountMeta(config_pda),
            AccountMeta(vault_pda, is_writable=True),
            AccountMeta(receipt_pda, is_writable=True),
            AccountMeta(b"\x00" * 32),
        ],
        data=bytes([1]) + (4_000).to_bytes(8, "little")
        + (1).to_bytes(8, "little"),
    ))
    check("L1 deposit moved lamports to vault",
          svm.balance(vault_pda) == 4_000)

    indexer = DepositIndexer(orch.store, orch.submit)
    n = sum(indexer.process_log(slot=10 + i, log_line=line)
            for i, line in enumerate(svm.logs))
    check("deposit indexer ingested ZE_DEPOSIT", n == 1)
    pend = orch.get_pending_account(alice)
    check("L2 balance credited (pending batch)",
          (pend.balance if pend else orch.get_account(alice).balance)
          == 4_000)

    tx = Transfer(signer_pubkey=alice, to=bob, amount=700, nonce=0)
    tx.signature = crypto.sign(alice_seed, tx.signing_message())
    check("L2 transfer accepted", orch.submit(tx).accepted)

    wd = Withdraw(from_=alice, to_l1_address=alice_l1, amount=1_500, nonce=1)
    wd.signature = crypto.sign(alice_seed, wd.signing_message())
    check("L2 withdrawal accepted", orch.submit(wd).accepted)

    orch.seal()
    deadline = time.time() + args.timeout
    while time.time() < deadline:
        orch.tick()
        if orch.stats.batches_settled:
            break
        time.sleep(0.02)
    check("batch proved + settled", orch.stats.batches_settled == 1)
    check("withdrawal executed on L1 (vault -> recipient)",
          svm.balance(alice_l1) == 1_500)
    check("final L2 balances",
          orch.get_account(alice).balance == 4_000 - 700 - 1_500
          and orch.get_account(bob).balance == 700)

    if args.zk:
        # REAL Groth16 verification through the SubmitBatch CPI
        # (zk_verification.rs equivalent; fast keygen on a 7-public-input
        # relation matching the batch circuit's public interface), the
        # keygen and the prove on --device
        from .groth16.prove import prove as g16_prove
        from .groth16.setup import keygen as g16_keygen
        from .sequencer.bridge_program import VERIFIER_PROGRAM_ID
        from .sequencer.onchain_verifier import vk_to_solana_account
        from .sequencer.prover_service import (
            BatchProof, BatchPublicInputs, proof_to_solana_bytes)
        from .sequencer.settler import build_submit_batch_instruction

        class _SevenInput:
            def __init__(self, vals):
                self.vals = vals

            def generate_constraints(self, cs):
                ins = [cs.new_input(v) for v in self.vals]
                prod = ins[0] * ins[1]
                expected = cs.new_witness(self.vals[0] * self.vals[1])
                prod.enforce_equal(expected)
                total = ins[2] + ins[3] + ins[4] + ins[5] + ins[6]
                tw = cs.new_witness(sum(self.vals[2:]))
                total.enforce_equal(tw)

        from .sequencer.bridge_program import decode_config

        roots = [bytes([i + 1]) + b"\x00" * 31 for i in range(6)]
        # the hash prove leg above does not advance the on-chain batch
        # index; read the live value so the CPI's sequence check passes
        prev_idx = decode_config(svm.account(config_pda).data)["batch_index"]
        next_idx = prev_idx + 1
        vals = [int.from_bytes(r, "little") for r in roots] + [next_idx]
        t0 = time.time()
        zk_pk = g16_keygen(_SevenInput(vals), seed=0, device=args.device)
        proof = g16_prove(zk_pk, _SevenInput(vals), batch_id=next_idx,
                          device=args.device)
        bp = BatchProof(BatchPublicInputs(*roots, batch_id=next_idx),
                        proof_to_solana_bytes(proof), 1)
        vk_pda = svm.store_vk(domain, vk_to_solana_account(zk_pk.vk))
        try:
            svm.process(Instruction(
                program_id=BRIDGE_PROGRAM_ID,
                accounts=[
                    AccountMeta(sequencer_auth, is_signer=True),
                    AccountMeta(config_pda, is_writable=True),
                    AccountMeta(VERIFIER_PROGRAM_ID),
                    AccountMeta(vk_pda),
                ],
                data=build_submit_batch_instruction(bp, prev_idx=prev_idx),
            ))
            ok = True
        except Exception as exc:  # noqa: BLE001
            print(f"    zk CPI error: {exc}")
            ok = False
        check(f"SubmitBatch Groth16 CPI verified "
              f"({time.time()-t0:.1f}s incl. keygen)", ok)

    print("e2e:", "OK" if failures == 0 else f"{failures} FAILURES")
    return 1 if failures else 0


def cmd_deploy(args):
    """Deploy the L1 side (cli `zelana deploy` + scripts store_vk): init
    the bridge PDAs on the in-repo program model and store the verifying
    key in chunks via the verifier's chunked-VK plan
    (groth16/solana_vk.upload_plan; reference
    scripts/src/bin/store_vk.rs:1-41). Writes a deployment descriptor."""
    import os

    from .groth16.keys import ProvingKey, VerifyingKey
    from .groth16.solana_vk import convert_vk, upload_plan
    from .sequencer.bridge_program import (
        AccountMeta, BridgeSVM, Instruction, BRIDGE_PROGRAM_ID,
        derive_config_pda, derive_vault_pda, derive_vk_pda)

    domain = (bytes.fromhex(args.domain) if args.domain
              else hashlib.sha256(b"zelana:dev-domain:v1").digest())
    sequencer_auth = (bytes.fromhex(args.authority) if args.authority
                      else b"\x22" * 32)

    if args.vk:
        with open(args.vk, "rb") as f:
            vk = VerifyingKey.deserialize_compressed(f.read())
    else:
        key_path = os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "artifacts", "l2_dummy_pk.npz")
        vk = ProvingKey.load_npz(key_path).vk
        print(f"using committed dummy-circuit vk ({key_path})")

    svm = BridgeSVM()
    config_pda, _ = derive_config_pda(domain)
    vault_pda, _ = derive_vault_pda(domain)
    vk_pda, _ = derive_vk_pda(domain)
    svm.process(Instruction(
        program_id=BRIDGE_PROGRAM_ID,
        accounts=[
            AccountMeta(sequencer_auth, is_signer=True, is_writable=True),
            AccountMeta(config_pda, is_writable=True),
            AccountMeta(vault_pda, is_writable=True),
            AccountMeta(b"\x00" * 32),
        ],
        data=bytes([0]) + sequencer_auth + domain,
    ))
    svk = convert_vk(vk)
    chunks = upload_plan(svk, domain=domain)
    svm.store_vk(domain, {
        "alpha_g1": svk.alpha_g1, "beta_g2": svk.beta_g2,
        "gamma_g2": svk.gamma_g2, "delta_g2": svk.delta_g2, "ic": svk.ic,
    })
    vk_hash = hashlib.blake2b(vk.serialize_compressed(),
                              digest_size=32).hexdigest()
    desc = {
        "network": args.network,
        "domain": domain.hex(),
        "sequencer_authority": sequencer_auth.hex(),
        "config_pda": config_pda.hex(),
        "vault_pda": vault_pda.hex(),
        "vk_pda": vk_pda.hex(),
        "vk_hash_blake2b": vk_hash,
        "vk_upload_chunks": len(chunks),
    }
    with open(args.out, "w") as f:
        json.dump(desc, f, indent=2)
    print(f"bridge initialized (config {config_pda.hex()[:16]}..., "
          f"vault {vault_pda.hex()[:16]}...)")
    print(f"vk stored in {len(chunks)} chunk instruction(s), "
          f"hash {vk_hash[:16]}...")
    print(f"deployment descriptor -> {args.out}")
    if args.network not in ("mock", "localnet"):
        print(f"note: network '{args.network}' has no RPC in this "
              "environment; deployment ran against the in-repo program "
              "model (litesvm equivalent)")
    return 0


def cmd_airdrop(args):
    """Fund an account for testing (cli/src/airdrop.rs
    airdrop_and_bridge_flow): against a RUNNING dev sequencer, drives the
    /dev/deposit faucet and polls until the balance lands."""
    from .sdk.client import ApiClient

    client = ApiClient(args.url)
    pubkey = bytes.fromhex(args.pubkey)
    acct0 = client.get_account(pubkey)
    before = (acct0.pending_balance if acct0.pending_balance is not None
              else acct0.balance)
    client.dev_deposit(pubkey, args.amount, l1_seq=args.l1_seq)
    deadline = time.time() + 10
    while time.time() < deadline:
        acct = client.get_account(pubkey)
        # the faucet credit lands in the accumulating batch first; the
        # pending view is the spendable balance (handlers.rs get_account)
        bal = (acct.pending_balance if acct.pending_balance is not None
               else acct.balance)
        if bal >= before + args.amount:
            print(f"airdropped {args.amount} -> {args.pubkey[:16]}... "
                  f"(balance {bal})")
            return 0
        time.sleep(0.2)
    print("airdrop did not land within 10s", file=sys.stderr)
    return 1


def cmd_genkey(args):
    """Generate a dual-key wallet file (cli `zelana genkey`,
    cli/src/main.rs:58-64: writes the keypair to id.json, mode 0600)."""
    import os

    from .sdk.keypair import ZelanaKeypair

    kp = ZelanaKeypair.generate()
    doc = {
        "signing_seed": kp.signing_seed.hex(),
        "privacy_sk": kp.privacy_sk.hex(),
        "pubkey": kp.pubkey.hex(),
        "privacy_pk": kp.privacy_pk.hex(),
    }
    path = args.filename
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
    with os.fdopen(fd, "w") as f:
        json.dump(doc, f, indent=2)
    print(f"keypair -> {path}\npubkey: {doc['pubkey']}\n"
          f"privacy pk: {doc['privacy_pk']}")
    return 0


def cmd_explorer(args):
    """Live store explorer (debug/web parity)."""
    from .sequencer.store import Store
    from .tools.explorer import start_explorer

    _, port = start_explorer(Store(args.db_path), args.port)
    print(f"explorer: http://127.0.0.1:{port}")
    try:
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        pass


def main(argv=None):
    parser = argparse.ArgumentParser(prog="zelana-tpu")
    parser.add_argument("--device", default="cuda",
                        help="device of the provers and keygens a command "
                        "builds (cuda, cpu)")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("dev", help="run the local sequencer stack")
    p.add_argument("--config", default=None)
    p.add_argument("--ephemeral", action="store_true",
                   help="bind an ephemeral HTTP port")
    p.set_defaults(fn=cmd_dev)

    p = sub.add_parser("keygen", help="Groth16 setup for the L2 circuit")
    p.add_argument("--pk-out", default="./proving.key")
    p.add_argument("--vk-out", default="./verifying.key")
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_keygen)

    p = sub.add_parser("prove", help="prove the demo batch")
    p.add_argument("--pk", default="./proving.key")
    p.add_argument("--batch-id", type=int, default=0)
    p.add_argument("--out", default="./l2_proof.json")
    p.set_defaults(fn=cmd_prove)

    p = sub.add_parser("verify", help="check a proof file")
    p.add_argument("--proof", default="./l2_proof.json")
    p.add_argument("--vk", default=None)
    p.add_argument("--inputs", default=None,
                   help="comma-separated public inputs")
    p.set_defaults(fn=cmd_verify)

    p = sub.add_parser("worker", help="chunk-proving worker service")
    p.add_argument("--capacity", default="8/4/4",
                   help="transfers/withdrawals/shielded per chunk")
    p.add_argument("--depth", type=int, default=32)
    p.add_argument("--port", type=int, default=0)
    p.set_defaults(fn=cmd_worker)

    p = sub.add_parser("node", help="blind MPC prover node")
    p.add_argument("--node-id", type=int, required=True)
    p.add_argument("--port", type=int, default=0)
    p.set_defaults(fn=cmd_node)

    p = sub.add_parser("test", help="self-contained e2e test "
                       "(L1 deposit -> L2 -> withdraw -> settle)")
    p.add_argument("--zk", action="store_true",
                   help="settle through the real Groth16 verifier CPI "
                   "(slow; default uses the hash prove leg)")
    p.add_argument("--timeout", type=float, default=30.0)
    p.set_defaults(fn=cmd_test)

    p = sub.add_parser("deploy", help="init bridge PDAs + chunked VK store "
                       "on the in-repo program model")
    p.add_argument("--network", default="mock")
    p.add_argument("--vk", default=None,
                   help="compressed verifying key file (default: committed "
                   "dummy-circuit key)")
    p.add_argument("--domain", default=None, help="32-byte hex domain")
    p.add_argument("--authority", default=None,
                   help="32-byte hex sequencer authority")
    p.add_argument("--out", default="./deployment.json")
    p.set_defaults(fn=cmd_deploy)

    p = sub.add_parser("airdrop", help="dev faucet against a running "
                       "sequencer (/dev/deposit)")
    p.add_argument("pubkey", help="32-byte hex L2 pubkey")
    p.add_argument("--amount", type=int, default=1_000_000)
    p.add_argument("--l1-seq", type=int, default=0)
    p.add_argument("--url", default="http://127.0.0.1:8899")
    p.set_defaults(fn=cmd_airdrop)

    p = sub.add_parser("genkey", help="generate a dual-key wallet file")
    p.add_argument("filename", nargs="?", default="id.json")
    p.set_defaults(fn=cmd_genkey)

    p = sub.add_parser("explorer", help="live store web explorer")
    p.add_argument("db_path")
    p.add_argument("--port", type=int, default=8899)
    p.set_defaults(fn=cmd_explorer)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
