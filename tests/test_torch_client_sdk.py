"""The port's client SDK (zelana_tpu_torch.sdk.keypair, sdk.client and
sdk.zephyr) against the JAX package's, on the CPU. Equality is exact.

Keys derived from the same seeds are equal, and so are the framed and
signed messages. The scripts of tests/test_client_sdk.py run twice: the
port's ZelanaClient against the port's API, and the JAX client against the
JAX API, each pipeline proving with a stub prover (MockProver's proof with
no sleep); every answer is compared. The encrypted UDP transport runs
across the packages both ways: the port's client to the JAX server, the
JAX client to the port's server.
"""

import dataclasses
import os
import time
from types import SimpleNamespace

import pytest
import torch

import zelana_tpu.sdk.client as JC
import zelana_tpu.sdk.keypair as JKP
import zelana_tpu.sdk.zephyr as JZ
import zelana_tpu.sequencer.api as JAPI
import zelana_tpu.sequencer.batch as JB
import zelana_tpu.sequencer.pipeline as JP
import zelana_tpu.sequencer.prover_service as JSP
import zelana_tpu.sequencer.transactions as JTX
import zelana_tpu_torch.sdk.client as TC
import zelana_tpu_torch.sdk.keypair as TKP
import zelana_tpu_torch.sdk.zephyr as TZ
import zelana_tpu_torch.sequencer.api as TAPI
import zelana_tpu_torch.sequencer.batch as TB
import zelana_tpu_torch.sequencer.pipeline as TP
import zelana_tpu_torch.sequencer.prover_service as TSP
import zelana_tpu_torch.sequencer.transactions as TTX
from zelana_tpu_torch.cli import HashProveLeg

torch.set_num_threads(1)

JAX = SimpleNamespace(c=JC, kp=JKP, z=JZ, api=JAPI, b=JB, p=JP, sp=JSP,
                      tx=JTX)
PORT = SimpleNamespace(c=TC, kp=TKP, z=TZ, api=TAPI, b=TB, p=TP, sp=TSP,
                       tx=TTX)


class StubProver:
    """MockProver's proof with no sleep, as a BatchProof of the package
    given."""

    def __init__(self, sp):
        self.sp = sp

    def prove(self, inputs, witness):
        proof = HashProveLeg().prove(inputs, witness)
        return self.sp.BatchProof(inputs, proof.proof_bytes, 0)


SEEDS = (b"\x01" * 32, b"\x02" * 32, bytes(range(32)))


@pytest.mark.parametrize("seed", SEEDS, ids=["ones", "twos", "ramp"])
def test_keypair_matches_jax(seed):
    t, j = TKP.ZelanaKeypair.from_seed(seed), JKP.ZelanaKeypair.from_seed(seed)
    assert (t.signing_seed, t.privacy_sk) == (j.signing_seed, j.privacy_sk)
    assert (t.pubkey, t.privacy_pk) == (j.pubkey, j.privacy_pk)
    fields = {"to": "ab" * 32, "amount": 5, "nonce": 0}
    assert (TKP.ZelanaKeypair.frame_message("Transfer", fields)
            == JKP.ZelanaKeypair.frame_message("Transfer", fields))
    sig = t.sign_message("Transfer", fields)
    assert sig == j.sign_message("Transfer", fields)
    assert t.sign_raw(b"msg") == j.sign_raw(b"msg")
    assert TKP.ZelanaKeypair.verify_raw(j.pubkey, b"msg", j.sign_raw(b"msg"))
    assert not TKP.ZelanaKeypair.verify_raw(t.pubkey, b"msh",
                                            t.sign_raw(b"msg"))


def client_session(pkg) -> list:
    """tests/test_client_sdk.py's scripts in one session against the
    package's API (dev mode off): transfers with auto-nonce, a bad
    signature, a withdrawal, the fast-withdraw quote, a shielded note and
    the scan, the prove-job API with its SSE stream, the pollers. Returns
    every answer, job ids taken out."""
    orch = pkg.p.PipelineOrchestrator(
        config=pkg.p.PipelineConfig(
            batch=pkg.b.BatchConfig(max_age_secs=3600)),
        prover=StubProver(pkg.sp), dev_mode=False)
    service = pkg.p.PipelineService(orch).start()
    server, port = pkg.api.start_api(orch)
    url = f"http://127.0.0.1:{port}"
    alice_kp = pkg.kp.ZelanaKeypair.from_seed(b"\x01" * 32)
    bob_kp = pkg.kp.ZelanaKeypair.from_seed(b"\x02" * 32)
    alice = pkg.c.ZelanaClient(url, keypair=alice_kp)
    bob = pkg.c.ZelanaClient(url, keypair=bob_kp)
    api = pkg.c.ApiClient(url)
    out = []

    def settle(n):
        alice.dev_seal()
        deadline = time.time() + 10
        while alice.get_stats()["batches_settled"] < n:
            assert time.time() < deadline, "batch did not settle"
            time.sleep(0.02)

    def refused(fn):
        try:
            return fn()
        except pkg.c.ApiError as exc:
            return ("ApiError", exc.status, exc.message)

    try:
        out += [alice.is_healthy(), alice.get_balance(), alice.get_nonce(),
                alice.dev_deposit(500), alice.get_account()]
        r1 = alice.transfer(bob.pubkey, 50)
        r2 = alice.transfer(bob.pubkey, 25)
        out += [r1, r2, alice.get_nonce()]
        tx = pkg.tx.Transfer(signer_pubkey=alice_kp.pubkey,
                             to=bob_kp.pubkey, amount=10, nonce=2)
        out.append(refused(lambda: api.submit_transfer(
            alice_kp.pubkey, bob_kp.pubkey, 10, 2,
            bob_kp.sign_raw(tx.signing_message()))))
        settle(1)
        out += [bob.get_balance(), alice.get_account(),
                alice.wait_for_transaction(r1["tx_hash"], timeout=5),
                alice.list_batches(), alice.wait_for_batch(0, timeout=5),
                alice.get_state_roots(), alice.get_batch_status(),
                alice.get_transaction("00" * 32), alice.get_batch(42),
                alice.list_transactions(), refused(lambda: api.get(
                    "/nope"))]
        wd = alice.withdraw(b"\x0b" * 32, 200)
        out.append(wd)
        settle(2)
        out += [alice.get_withdrawal_status(wd["tx_hash"]),
                alice.get_fast_withdraw_quote(100),
                refused(lambda: alice.fast_withdraw(b"\x0b" * 32, 10))]
        out.append(api.submit_shielded(
            nullifier=b"\x03" * 32, commitment=b"\x04" * 32,
            proof=b"\x00" * 324, ciphertext=b"\xaa" * 16))
        settle(3)
        out += [api.scan_notes(), api.get_merkle_path(0),
                api.get_shielded_root().hex(),
                refused(lambda: sorted(api.get_committee()))]
        alice.dev_deposit_to(bob_kp.pubkey, 50, l1_seq=7)
        job = api.prove_batch()
        out.append(list(api.stream_status(job, timeout=20)))
        proof = api.wait_for_proof(job, timeout=20)
        proof.pop("job_id", None)
        out += [proof, api.prove_status(job),
                [api.detect_proof_format(b"\x00" * n)
                 for n in (388, 624, 256, 10)]]
    finally:
        server.shutdown()
        server.server_close()
        service.stop()
    return [dataclasses.asdict(a) if dataclasses.is_dataclass(a) else a
            for a in out]  # the AccountStates, class aside


def test_client_answers_match_jax():
    want = client_session(JAX)
    got = client_session(PORT)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, i
    assert got[0] is True and got[5]["accepted"] and got[9] == 75
    assert got[8] == ("ApiError", 400, "invalid signature")


def test_client_refuses_without_keypair():
    for pkg in (JAX, PORT):
        with pytest.raises(ValueError, match="no keypair"):
            pkg.c.ZelanaClient("http://127.0.0.1:9").pubkey
        assert not pkg.c.ZelanaClient("http://127.0.0.1:9",
                                      timeout=0.5).is_healthy()


def test_zephyr_session_keys_match_jax():
    for shared in (b"\x00" * 32, bytes(range(32))):
        assert (TZ.derive_session_keys(shared)
                == JZ.derive_session_keys(shared))


def test_zephyr_across_packages(monkeypatch):
    """The encrypted UDP round trip both ways. With one urandom stream the
    two servers' and clients' keys, nonces and packets are equal too."""
    seen = {}

    def handler(req):
        return {"echo": req, "n": len(req)}

    for name, server_pkg, client_pkg in (("jax<-port", JAX, PORT),
                                         ("port<-jax", PORT, JAX),
                                         ("port<-port", PORT, PORT)):
        stream = iter(range(10**6))
        monkeypatch.setattr(os, "urandom", lambda n: bytes(
            next(stream) % 251 + 1 for _ in range(n)))
        server = server_pkg.z.ZephyrServer(handler, port=0).start()
        client = client_pkg.z.ZephyrClient(("127.0.0.1", server.port))
        try:
            client.handshake()
            answers = [client.request({"from": "aa" * 32, "amount": i})
                       for i in range(3)]
            seen[name] = (server.pk, client.pk, client.c2s_key,
                          client.s2c_key, answers)
            assert answers[2] == {"echo": {"from": "aa" * 32, "amount": 2},
                                  "n": 2}
            assert len(server.sessions) == 1
        finally:
            client.close()
            server.stop()
    assert seen["jax<-port"] == seen["port<-jax"] == seen["port<-port"]


def test_zephyr_drops_bad_packets():
    server = TZ.ZephyrServer(lambda req: {"ok": True}, port=0).start()
    client = TZ.ZephyrClient(("127.0.0.1", server.port), timeout=0.3)
    try:
        client.sock.sendto(bytes([TZ.APP_DATA]) + b"\x00" * 40,
                           ("127.0.0.1", server.port))  # no session yet
        client.handshake()
        client.sock.sendto(bytes([TZ.APP_DATA]) + b"\x01" * 40,
                           ("127.0.0.1", server.port))  # bad tag
        assert client.request({"a": 1}) == {"ok": True}
    finally:
        client.close()
        server.stop()
