"""Full-lifecycle end-to-end script (scripts/src/bin/e2e_test.rs +
core/examples/full_lifecycle.rs parity).

    python -m zelana_tpu_torch.tools.e2e

Drives the whole stack in-process: init the bridge program model, L1
deposit (ZE_DEPOSIT log) -> deposit indexer -> L2 transfer -> L2
withdrawal -> batch seal/prove/settle -> WithdrawAttested moving vault
lamports to the L1 recipient. Prints each leg; exits nonzero on any
mismatch. The batch mixes a deposit, a transfer and a withdrawal, a shape
no key in the repo fits: it is proved by the CLI's `HashProveLeg`, as the
JAX package proves it with its mock prover, and touches no device."""

from __future__ import annotations

import sys
import time


def main() -> int:
    from ..cli import HashProveLeg
    from ..sequencer import crypto
    from ..sequencer.batch import BatchConfig
    from ..sequencer.bridge import DepositIndexer
    from ..sequencer.bridge_program import (
        BRIDGE_PROGRAM_ID,
        AccountMeta,
        BridgeSVM,
        Instruction,
        derive_config_pda,
        derive_deposit_receipt_pda,
        derive_vault_pda,
    )
    from ..sequencer.pipeline import (
        PipelineConfig,
        PipelineOrchestrator,
    )
    from ..sequencer.settler import BridgeProgramSettler, MockSettler
    from ..sequencer.transactions import Transfer, Withdraw

    domain = b"\x11" * 32
    sequencer_key = b"\x22" * 32
    alice_seed, bob_seed = b"\x01" * 32, b"\x02" * 32
    _, _, alice = crypto.secret_to_keypair(alice_seed)
    _, _, bob = crypto.secret_to_keypair(bob_seed)
    alice_l1 = b"\x77" * 32

    svm = BridgeSVM()
    config_pda, _ = derive_config_pda(domain)
    vault_pda, _ = derive_vault_pda(domain)
    svm.process(Instruction(
        program_id=BRIDGE_PROGRAM_ID,
        accounts=[AccountMeta(alice, True, True),
                  AccountMeta(config_pda, is_writable=True),
                  AccountMeta(vault_pda, is_writable=True),
                  AccountMeta(b"\x00" * 32)],
        data=bytes([0]) + sequencer_key + domain,
    ))
    print("[1] bridge initialized (config + vault PDAs)")

    svm.airdrop(alice, 100_000)
    receipt_pda, _ = derive_deposit_receipt_pda(domain, alice, 1)
    svm.process(Instruction(
        program_id=BRIDGE_PROGRAM_ID,
        accounts=[AccountMeta(alice, True, True), AccountMeta(config_pda),
                  AccountMeta(vault_pda, is_writable=True),
                  AccountMeta(receipt_pda, is_writable=True),
                  AccountMeta(b"\x00" * 32)],
        data=bytes([1]) + (50_000).to_bytes(8, "little")
        + (1).to_bytes(8, "little"),
    ))
    print(f"[2] L1 deposit: vault = {svm.balance(vault_pda)} lamports")

    class HybridSettler(BridgeProgramSettler):
        def submit(self, proof):  # hash proofs can't pass the ZK CPI
            return MockSettler().submit(proof)

    orch = PipelineOrchestrator(
        config=PipelineConfig(batch=BatchConfig(max_age_secs=3600)),
        prover=HashProveLeg(),
        settler=HybridSettler(svm, domain, sequencer_key),
        dev_mode=False,
    )
    indexer = DepositIndexer(orch.store, orch.submit)
    ingested = sum(indexer.process_log(10 + i, line)
                   for i, line in enumerate(svm.logs))
    assert ingested == 1, "deposit not ingested"
    print("[3] deposit indexed into L2")

    tx = Transfer(signer_pubkey=alice, to=bob, amount=10_000, nonce=0)
    tx.signature = crypto.sign(alice_seed, tx.signing_message())
    assert orch.submit(tx).accepted
    print("[4] L2 transfer alice -> bob accepted")

    wd = Withdraw(from_=bob, to_l1_address=alice_l1, amount=4_000, nonce=0)
    wd.signature = crypto.sign(bob_seed, wd.signing_message())
    assert orch.submit(wd).accepted
    orch.seal()
    deadline = time.time() + 10
    while time.time() < deadline and orch.stats.batches_settled == 0:
        orch.tick()
        time.sleep(0.02)
    assert orch.stats.batches_settled == 1, "settlement did not complete"
    print("[5] batch sealed, proved, settled")

    assert orch.get_account(alice).balance == 40_000
    assert orch.get_account(bob).balance == 6_000
    assert svm.balance(alice_l1) == 4_000
    assert svm.balance(vault_pda) == 46_000
    print(f"[6] withdrawal executed on L1: recipient = "
          f"{svm.balance(alice_l1)}, vault = {svm.balance(vault_pda)}")
    print("e2e OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
