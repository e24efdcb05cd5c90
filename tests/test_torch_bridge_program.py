"""The L1 side of the port (zelana_tpu_torch.groth16.solana_vk,
sequencer.bridge_program, the settler's BridgeProgramSettler and the
WebSocket log feed sequencer.ws) against the JAX package's, on the CPU.
Equality is exact: bytes, accounts, logs, errors.

The scripts of tests/test_bridge_program.py (init, deposit, withdraw
attested with its replay and authority refusals, the full L1 -> L2 -> L1
loop) run through both packages' BridgeSVM with one clock, and every
account, log line and refusal is compared. The SubmitBatch CPI verifies
the `_SevenInput` proof of `cli test --zk` recorded with the JAX package
(testdata/cli_vectors.json, tools/record_service_vectors.py cli), with
no live JAX prove. The port's WebSocket client subscribes to the JAX
server and the JAX client to the port's, each feeding a deposit indexer.
"""

import io
import json
import os
import time
from types import SimpleNamespace

import pytest
import torch

import zelana_tpu.groth16.keys as JK
import zelana_tpu.groth16.solana_vk as JVK
import zelana_tpu.sequencer.batch as JB
import zelana_tpu.sequencer.bridge as JBR
import zelana_tpu.sequencer.bridge_program as JBP
import zelana_tpu.sequencer.crypto as JCR
import zelana_tpu.sequencer.pipeline as JP
import zelana_tpu.sequencer.prover_service as JSP
import zelana_tpu.sequencer.settler as JS
import zelana_tpu.sequencer.transactions as JTX
import zelana_tpu.sequencer.ws as JWS
import zelana_tpu_torch.groth16.keys as TK
import zelana_tpu_torch.groth16.solana_vk as TVK
import zelana_tpu_torch.sequencer.batch as TB
import zelana_tpu_torch.sequencer.bridge as TBR
import zelana_tpu_torch.sequencer.bridge_program as TBP
import zelana_tpu_torch.sequencer.crypto as TCR
import zelana_tpu_torch.sequencer.pipeline as TP
import zelana_tpu_torch.sequencer.prover_service as TSP
import zelana_tpu_torch.sequencer.settler as TS
import zelana_tpu_torch.sequencer.transactions as TTX
import zelana_tpu_torch.sequencer.ws as TWS
from zelana_tpu_torch.cli import HashProveLeg

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTDATA = os.path.join(ROOT, "zelana_tpu_torch", "testdata")
L2_KEY = os.path.join(ROOT, "artifacts", "l2_dummy_pk.npz")

JAX = SimpleNamespace(bp=JBP, s=JS, b=JB, br=JBR, p=JP, tx=JTX, cr=JCR,
                      sp=JSP, ws=JWS, k=JK)
PORT = SimpleNamespace(bp=TBP, s=TS, b=TB, br=TBR, p=TP, tx=TTX, cr=TCR,
                       sp=TSP, ws=TWS, k=TK)

DOMAIN = b"\x11" * 32
SEQUENCER = b"\x22" * 32
ALICE = b"\x33" * 32
BOB = b"\x44" * 32
CLOCK = 1_760_000_000


class StubProver:
    """MockProver's proof with no sleep, as a BatchProof of the package
    given (the JAX side's counterpart of the port's HashProveLeg)."""

    def __init__(self, sp):
        self.sp = sp

    def prove(self, inputs, witness):
        proof = HashProveLeg().prove(inputs, witness)
        return self.sp.BatchProof(inputs, proof.proof_bytes, 0)


@pytest.fixture(scope="module")
def vectors():
    with open(os.path.join(TESTDATA, "cli_vectors.json")) as f:
        return json.load(f)


def svm_of(pkg):
    svm = pkg.bp.BridgeSVM()
    svm.clock = CLOCK
    svm.seen = []  # every instruction's data, in order
    process = svm.process

    def keep(ix):
        svm.seen.append(ix.data)
        return process(ix)

    svm.process = keep
    return svm


def state(svm) -> dict:
    return {"accounts": {k.hex(): (a.lamports, a.data.hex(), a.owner.hex())
                         for k, a in sorted(svm.accounts.items())},
            "logs": list(svm.logs), "seen": [d.hex() for d in svm.seen]}


def attempt(fn) -> str:
    """'ok', or the refusal's class name and message."""
    try:
        fn()
    except Exception as exc:  # noqa: BLE001
        return f"{type(exc).__name__}: {exc}"
    return "ok"


def meta(pkg, key, signer=False, writable=False):
    return pkg.bp.AccountMeta(key, is_signer=signer, is_writable=writable)


def init(pkg, svm, payer=ALICE):
    config_pda, _ = pkg.bp.derive_config_pda(DOMAIN)
    vault_pda, _ = pkg.bp.derive_vault_pda(DOMAIN)
    return attempt(lambda: svm.process(pkg.bp.Instruction(
        program_id=pkg.bp.BRIDGE_PROGRAM_ID,
        accounts=[meta(pkg, payer, True, True),
                  meta(pkg, config_pda, writable=True),
                  meta(pkg, vault_pda, writable=True),
                  meta(pkg, b"\x00" * 32)],
        data=bytes([0]) + SEQUENCER + DOMAIN)))


def deposit(pkg, svm, depositor, amount, nonce):
    config_pda, _ = pkg.bp.derive_config_pda(DOMAIN)
    vault_pda, _ = pkg.bp.derive_vault_pda(DOMAIN)
    receipt, _ = pkg.bp.derive_deposit_receipt_pda(DOMAIN, depositor, nonce)
    return attempt(lambda: svm.process(pkg.bp.Instruction(
        program_id=pkg.bp.BRIDGE_PROGRAM_ID,
        accounts=[meta(pkg, depositor, True, True), meta(pkg, config_pda),
                  meta(pkg, vault_pda, writable=True),
                  meta(pkg, receipt, writable=True),
                  meta(pkg, b"\x00" * 32)],
        data=bytes([1]) + amount.to_bytes(8, "little")
        + nonce.to_bytes(8, "little"))))


def withdraw(pkg, svm, signer, recipient, amount, nullifier):
    config_pda, _ = pkg.bp.derive_config_pda(DOMAIN)
    vault_pda, _ = pkg.bp.derive_vault_pda(DOMAIN)
    nf_pda, _ = pkg.bp.derive_nullifier_pda(DOMAIN, nullifier)
    return attempt(lambda: svm.process(pkg.bp.Instruction(
        program_id=pkg.bp.BRIDGE_PROGRAM_ID,
        accounts=[meta(pkg, signer, signer=True), meta(pkg, config_pda),
                  meta(pkg, vault_pda, writable=True),
                  meta(pkg, recipient, writable=True),
                  meta(pkg, nf_pda, writable=True),
                  meta(pkg, b"\x00" * 32)],
        data=bytes([2]) + recipient + amount.to_bytes(8, "little")
        + nullifier)))


def script_init(pkg, svm):
    return [init(pkg, svm), init(pkg, svm),
            attempt(lambda: pkg.bp.decode_config(b"\x00" * 10)),
            pkg.bp.decode_config(svm.account(
                pkg.bp.derive_config_pda(DOMAIN)[0]).data)]


def script_deposit(pkg, svm):
    init(pkg, svm)
    svm.airdrop(ALICE, 10_000)
    return [deposit(pkg, svm, ALICE, 4_000, 1),
            deposit(pkg, svm, ALICE, 4_000, 1),   # receipt exists: dedup
            deposit(pkg, svm, ALICE, 1_000, 2),
            deposit(pkg, svm, ALICE, 0, 3),
            deposit(pkg, svm, ALICE, 99_000, 4),  # insufficient funds
            deposit(pkg, svm, b"\x44" * 32, 5, 1)]


def script_withdraw(pkg, svm):
    init(pkg, svm)
    svm.airdrop(ALICE, 10_000)
    deposit(pkg, svm, ALICE, 8_000, 1)
    recipient, nullifier = b"\x44" * 32, b"\x55" * 32
    return [withdraw(pkg, svm, SEQUENCER, recipient, 3_000, nullifier),
            withdraw(pkg, svm, SEQUENCER, recipient, 3_000, nullifier),
            withdraw(pkg, svm, ALICE, recipient, 1, b"\x66" * 32),
            withdraw(pkg, svm, SEQUENCER, recipient, 9_000, b"\x67" * 32),
            attempt(lambda: svm.process(pkg.bp.Instruction(
                program_id=b"\x01" * 32, accounts=[], data=b"\x00"))),
            attempt(lambda: svm.process(pkg.bp.Instruction(
                program_id=pkg.bp.BRIDGE_PROGRAM_ID, accounts=[],
                data=b"\x09")))]


@pytest.mark.parametrize("script", [script_init, script_deposit,
                                    script_withdraw])
def test_bridge_scripts_match_jax(script):
    jsvm, tsvm = svm_of(JAX), svm_of(PORT)
    want, got = script(JAX, jsvm), script(PORT, tsvm)
    assert got == want
    assert state(tsvm) == state(jsvm)
    assert "ok" in got[0] and any(r != "ok" for r in got[1:])


def test_pdas_and_codecs_match_jax():
    for name in ("BRIDGE_PROGRAM_ID", "VERIFIER_PROGRAM_ID",
                 "VERIFY_BATCH_PROOF_DISCRIMINATOR"):
        assert getattr(TBP, name) == getattr(JBP, name)
    seeds = [b"config", DOMAIN, b"\x07" * 32, (5).to_bytes(8, "little")]
    assert (TBP.find_program_address(seeds, ALICE)
            == JBP.find_program_address(seeds, ALICE))
    for fn, args in (("derive_config_pda", (DOMAIN,)),
                     ("derive_vault_pda", (DOMAIN,)),
                     ("derive_vk_pda", (DOMAIN,)),
                     ("derive_deposit_receipt_pda", (DOMAIN, ALICE, 9)),
                     ("derive_nullifier_pda", (DOMAIN, b"\x09" * 32)),
                     ("encode_config", (SEQUENCER, DOMAIN, b"\x05" * 32, 7,
                                        255, True)),
                     ("encode_receipt", (ALICE, DOMAIN, 5, 6, CLOCK, 254)),
                     ("encode_nullifier", (DOMAIN, b"\x01" * 32, ALICE, 3,
                                           253))):
        assert getattr(TBP, fn)(*args) == getattr(JBP, fn)(*args), fn


def full_loop(pkg, settler_cls):
    """test_bridge_program.py's full loop: L1 deposit -> indexer -> L2
    withdrawal -> settlement with the real WithdrawAttested leg (submit
    through MockSettler) -> the nullifier replay refused."""
    svm = svm_of(pkg)
    init(pkg, svm)
    alice_seed = b"\x01" * 32
    _, _, alice = pkg.cr.secret_to_keypair(alice_seed)
    alice_l1 = b"\x77" * 32
    svm.airdrop(alice, 10_000)

    class NoVerify(settler_cls):
        def submit(self, proof):
            return pkg.s.MockSettler().submit(proof)

    settler = NoVerify(svm, DOMAIN, SEQUENCER)
    orch = pkg.p.PipelineOrchestrator(
        config=pkg.p.PipelineConfig(
            batch=pkg.b.BatchConfig(max_age_secs=3600)),
        prover=StubProver(pkg.sp), settler=settler, dev_mode=False)
    out = [deposit(pkg, svm, alice, 4_000, 1)]
    indexer = pkg.br.DepositIndexer(orch.store, orch.submit)
    out.append(sum(indexer.process_log(slot=10 + i, log_line=line)
                   for i, line in enumerate(svm.logs)))
    out.append(any(indexer.process_log(99, line) for line in svm.logs))
    wd = pkg.tx.Withdraw(from_=alice, to_l1_address=alice_l1, amount=1_500,
                         nonce=0)
    wd.signature = pkg.cr.sign(alice_seed, wd.signing_message())
    out.append(orch.submit(wd).accepted)
    orch.seal()
    deadline = time.time() + 10
    while time.time() < deadline and not orch.stats.batches_settled:
        orch.tick()
        time.sleep(0.01)
    out += [orch.stats.batches_settled, svm.balance(alice_l1),
            orch.get_account(alice).balance]
    out.append(attempt(lambda: settler.execute_withdrawals(
        [(alice_l1, 1_500, pkg.p.tx_hash(wd))])))
    results = settler.execute_withdrawals(
        [(b"\x78" * 32, 100, b"\x31" * 32), (b"\x79" * 32, 200,
                                             b"\x32" * 32)])
    out.append([(r.signature, r.slot) for r in results])
    return out, state(svm)


def test_full_loop_matches_jax():
    want = full_loop(JAX, JS.BridgeProgramSettler)
    got = full_loop(PORT, TS.BridgeProgramSettler)
    assert got == want
    assert got[0][:7] == ["ok", 1, False, True, 1, 1_500, 2_500]
    assert got[0][7].startswith("ProgramError: replay attempt")


def vk_of_account(account) -> TK.VerifyingKey:
    """The verifying key a verifier account holds (big-endian
    coordinates, G2 with the imaginary part first)."""
    def g1(b):
        return int.from_bytes(b[:32], "big"), int.from_bytes(b[32:], "big")

    def g2(b):
        x1, x0, y1, y0 = (int.from_bytes(b[i:i + 32], "big")
                          for i in range(0, 128, 32))
        return (x0, x1), (y0, y1)

    return TK.VerifyingKey(g1(account["alpha_g1"]), g2(account["beta_g2"]),
                           g2(account["gamma_g2"]), g2(account["delta_g2"]),
                           [g1(p) for p in account["ic"]])


@pytest.fixture(scope="module")
def zk(vectors):
    """The recorded SubmitBatch of `cli test --zk`, its verifier account
    and the verifying key that account holds (compressed bytes, which both
    packages decode)."""
    t = vectors["test_zk"]
    account = {k: [bytes.fromhex(p) for p in v] if k == "ic"
               else bytes.fromhex(v) for k, v in t["vk_account"].items()}
    roots = [bytes([i + 1]) + b"\x00" * 31 for i in range(6)]
    return SimpleNamespace(account=account, roots=roots,
                           vk=vk_of_account(account).serialize_compressed(),
                           submit=bytes.fromhex(t["submit_batch"]),
                           proof=bytes.fromhex(t["proof"]),
                           batch_id=t["batch_id"])


def zk_script(pkg, zk):
    svm = svm_of(pkg)
    init(pkg, svm, payer=SEQUENCER)
    config_pda, _ = pkg.bp.derive_config_pda(DOMAIN)
    vk_pda = svm.store_vk(DOMAIN, zk.account)
    inputs = pkg.sp.BatchPublicInputs(*zk.roots, batch_id=zk.batch_id)
    ix = pkg.s.build_submit_batch_instruction(
        pkg.sp.BatchProof(inputs, zk.proof, 1), prev_idx=0)

    def submit(data):
        return attempt(lambda: svm.process(pkg.bp.Instruction(
            program_id=pkg.bp.BRIDGE_PROGRAM_ID,
            accounts=[meta(pkg, SEQUENCER, signer=True),
                      meta(pkg, config_pda, writable=True),
                      meta(pkg, pkg.bp.VERIFIER_PROGRAM_ID),
                      meta(pkg, vk_pda)],
            data=data)))

    bad = bytearray(ix)
    bad[1 + 56 + 8] ^= 1  # a proof byte
    out = [ix == zk.submit, submit(bytes(bad)), submit(ix), submit(ix),
           pkg.bp.decode_config(svm.account(config_pda).data)]
    return out, state(svm)


def test_submit_batch_zk_cpi_matches_jax(zk):
    want, got = zk_script(JAX, zk), zk_script(PORT, zk)
    assert got == want
    (same, tampered, first, again, cfg), _ = got
    assert same and first == "ok"
    assert tampered.startswith("ProgramError")
    assert again == "ProgramError: invalid prev_batch_index"
    assert cfg["batch_index"] == 1


def settler_script(pkg, zk):
    """BridgeProgramSettler: store_vk, submit through the CPI, then the
    withdrawals; its instruction bytes are in the svm's `seen`."""
    svm = svm_of(pkg)
    init(pkg, svm, payer=SEQUENCER)
    svm.airdrop(ALICE, 5_000)
    deposit(pkg, svm, ALICE, 5_000, 1)
    settler = pkg.s.BridgeProgramSettler(svm, DOMAIN, SEQUENCER)
    vk_pda = settler.store_vk(pkg.k.VerifyingKey.deserialize_compressed(
        zk.vk))
    inputs = pkg.sp.BatchPublicInputs(*zk.roots, batch_id=zk.batch_id)
    res = settler.submit(pkg.sp.BatchProof(inputs, zk.proof, 1))
    wds = settler.execute_withdrawals([(b"\x44" * 32, 1_200, b"\x55" * 32)])
    return ([vk_pda, (res.signature, res.slot),
             [(r.signature, r.slot) for r in wds],
             attempt(lambda: settler.submit(pkg.sp.BatchProof(
                 inputs, zk.proof, 1)))], state(svm))


def test_bridge_program_settler_matches_jax(zk):
    want, got = settler_script(JAX, zk), settler_script(PORT, zk)
    assert got == want
    (vk_pda, (sig, slot), wds, again), st = got
    assert vk_pda == TBP.derive_vk_pda(DOMAIN)[0] and slot == 1
    # the settler reads the new batch index: a resubmission is stale
    assert again == "ProgramError: invalid new_batch_index"
    assert [d[:2] for d in st["seen"]] == ["00", "01", "03", "02", "03"]
    assert len(wds) == 1
    assert st["accounts"][(b"\x44" * 32).hex()][0] == 1_200


# ------------------------------------------------------------- solana_vk


@pytest.fixture(scope="module")
def l2_vks():
    return (JK.ProvingKey.load_npz(L2_KEY).vk,
            TK.ProvingKey.load_npz(L2_KEY).vk)


@pytest.mark.parametrize("convert", [
    lambda m, vk: m.convert_vk(vk).to_json(),
    lambda m, vk: m.convert_vk_reference_le(vk).to_json(),
    lambda m, vk: m.upload_plan(m.convert_vk(vk)),
    lambda m, vk: m.upload_plan(m.convert_vk(vk), domain=DOMAIN, chunk=2),
    lambda m, vk: m.export_vk_snarkjs(vk),
    lambda m, vk: [m.g1_to_solana(None), m.g2_to_solana(None),
                   m.g1_to_reference_le(None), m.g2_to_reference_le(None)],
], ids=["convert_vk", "reference_le", "upload_plan", "upload_plan_2",
        "snarkjs", "identities"])
def test_solana_vk_matches_jax(l2_vks, convert):
    jvk, tvk = l2_vks
    got = convert(TVK, tvk)
    assert got == convert(JVK, jvk)
    assert got


def test_solana_vk_refuses_too_many_ic(l2_vks):
    _, tvk = l2_vks
    big = TK.VerifyingKey(tvk.alpha_g1, tvk.beta_g2, tvk.gamma_g2,
                          tvk.delta_g2, list(tvk.gamma_abc_g1) * 2)
    with pytest.raises(AssertionError, match="at most 8 IC points"):
        TVK.convert_vk(big)


# -------------------------------------------------------------------- ws


class FakeSock:
    def __init__(self, data):
        self.buf = io.BytesIO(data)

    def recv(self, n):
        return self.buf.read(n)


def test_ws_accept_key_and_frames_match_jax(monkeypatch):
    for key in ("dGhlIHNhbXBsZSBub25jZQ==", "AAAAAAAAAAAAAAAAAAAAAA=="):
        assert TWS.accept_key(key) == JWS.accept_key(key)
    assert TWS.accept_key("dGhlIHNhbXBsZSBub25jZQ==") == (
        "s3pPLMBiTxaQ9kYGzzhZRbK+xOo=")
    monkeypatch.setattr(os, "urandom", lambda n: bytes(range(1, n + 1)))
    for payload in (b"", b"hi", b"x" * 200, b"y" * 70000):
        for mask in (True, False):
            for op in (TWS.OP_TEXT, TWS.OP_PING, TWS.OP_CLOSE):
                frame = TWS.encode_frame(op, payload, mask=mask)
                assert frame == JWS.encode_frame(op, payload, mask=mask)
                assert TWS.read_frame(FakeSock(frame)) == (op, payload)
                assert JWS.read_frame(FakeSock(frame)) == (op, payload)


def ws_indexer(feed_pkg, server_pkg):
    """`feed_pkg`'s indexer, pipeline and ws_log_feed subscribed to
    `server_pkg`'s LogsSubscribeServer: a deposit line published twice
    (the second a replay the indexer drops), then settled."""
    orch = feed_pkg.p.PipelineOrchestrator(
        config=feed_pkg.p.PipelineConfig(
            batch=feed_pkg.b.BatchConfig(max_age_secs=3600)),
        prover=StubProver(feed_pkg.sp), dev_mode=True)
    idx = feed_pkg.br.DepositIndexer(orch.store, orch.submit)
    pubsub = server_pkg.ws.LogsSubscribeServer()
    try:
        thread = feed_pkg.ws.start_ws_indexer(
            idx, "127.0.0.1", pubsub.port, bridge_program="ZeBridge111")
        deadline = time.time() + 5
        while time.time() < deadline and not pubsub._subs:
            time.sleep(0.01)
        assert pubsub._subs, "the indexer never subscribed"
        line = f"Program log: ZE_DEPOSIT:{ALICE.hex()}:750:1"
        pubsub.publish(10, ["Program ZeBridge111 invoke [1]", line])
        pubsub.publish(11, [line])  # the same l1_seq: dropped
        pubsub.publish(12, [f"Program log: ZE_DEPOSIT:{BOB.hex()}:5:2"])
        deadline = time.time() + 5
        while time.time() < deadline and idx.last_processed_slot() != 12:
            time.sleep(0.01)
        out = [orch.stats.submitted, idx.last_processed_slot()]
        orch.seal()
        deadline = time.time() + 5
        while time.time() < deadline and not orch.stats.batches_settled:
            orch.tick()
            time.sleep(0.01)
        thread.stop.set()
        return out + [orch.get_account(ALICE).balance,
                      orch.get_account(BOB).balance]
    finally:
        pubsub.close()


def test_ws_indexer_across_packages():
    want = ws_indexer(JAX, JAX)
    assert want == [2, 12, 750, 5]
    assert ws_indexer(PORT, JAX) == want
    assert ws_indexer(JAX, PORT) == want


def test_ws_echo_across_packages():
    def upper(conn):
        while (text := conn.recv_text()) is not None:
            conn.send_text(text.upper())

    for server_pkg, client_pkg in ((JAX, PORT), (PORT, JAX)):
        server = server_pkg.ws.WsServer(upper)
        try:
            client = client_pkg.ws.WsClient("127.0.0.1", server.port)
            client.send_text("zelana" * 30_000)
            assert client.recv_text() == "ZELANA" * 30_000
            client.close()
        finally:
            server.close()
