"""The served sequencer of the port (zelana_tpu_torch.sequencer: pipeline,
api, store, settler, on-chain verifier gate, and the host modules under
them) against the JAX package's, on the CPU. Equality is exact.

The same transaction scripts (those of tests/test_sequencer.py) go through
both packages' pipelines, each with a stub prover that makes MockProver's
blake2b proof without its sleep and with the MockSettler, and every piece of
state they keep is compared: roots, accounts, batch and tx records,
shielded roots and paths, notes, withdrawal statuses, the settler's
instruction bytes. Both APIs answer the same requests with the same JSON.
In GROTH16 mode the port's pipeline is held to
zelana_tpu_torch/testdata/pipeline_l2_proof.json, which
tools/record_service_vectors.py recorded with the JAX pipeline: the folded
public inputs and witness, and the on-chain verifier gate accepting the
recorded proof and refusing it with one byte flipped. ZELANA_SLOW_TESTS=1
adds the port pipeline's own prove on the CPU against that vector (about
70 s). chip_smoke.py's `sequencer` phase serves the same batch on the card.
"""

import dataclasses
import hashlib
import json
import os
import sys
import time
import urllib.request
from types import SimpleNamespace

import pytest
import torch

import zelana_tpu.sdk.threshold as JTH
import zelana_tpu.sequencer.account_tree as JAT
import zelana_tpu.sequencer.api as JAPI
import zelana_tpu.sequencer.batch as JB
import zelana_tpu.sequencer.config as JCFG
import zelana_tpu.sequencer.crypto as JCR
import zelana_tpu.sequencer.pipeline as JP
import zelana_tpu.sequencer.prover_service as JSP
import zelana_tpu.sequencer.settler as JS
import zelana_tpu.sequencer.store as JST
import zelana_tpu.sequencer.transactions as JTX
import zelana_tpu_torch.sdk.threshold as TTH
import zelana_tpu_torch.sequencer.account_tree as TAT
import zelana_tpu_torch.sequencer.api as TAPI
import zelana_tpu_torch.sequencer.batch as TB
import zelana_tpu_torch.sequencer.config as TCFG
import zelana_tpu_torch.sequencer.crypto as TCR
import zelana_tpu_torch.sequencer.pipeline as TP
import zelana_tpu_torch.sequencer.prover_service as TSP
import zelana_tpu_torch.sequencer.settler as TS
import zelana_tpu_torch.sequencer.store as TST
import zelana_tpu_torch.sequencer.transactions as TTX

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTDATA = os.path.join(ROOT, "zelana_tpu_torch", "testdata")
L2_KEY = os.path.join(ROOT, "artifacts", "l2_dummy_pk.npz")
sys.path.insert(0, os.path.join(ROOT, "tools"))
from record_service_vectors import http, serve_l2_batch  # noqa: E402

JAX = SimpleNamespace(th=JTH, api=JAPI, b=JB, cr=JCR, p=JP, sp=JSP, s=JS,
                      tx=JTX)
PORT = SimpleNamespace(th=TTH, api=TAPI, b=TB, cr=TCR, p=TP, sp=TSP, s=TS,
                       tx=TTX)

ALICE_SEED, BOB_SEED = b"\x01" * 32, b"\x02" * 32
_, _, ALICE = JCR.secret_to_keypair(ALICE_SEED)
_, _, BOB = JCR.secret_to_keypair(BOB_SEED)
L1 = b"\x09" * 32


class StubProver:
    """MockProver's proof (zelana_tpu/sequencer/prover_service.py:145-166):
    blake2b over the public inputs, padded to 256 bytes, with no sleep;
    the BatchProof of the package given."""

    def __init__(self, sp):
        self.sp = sp
        self.seen = []

    def prove(self, inputs, witness):
        self.seen.append((inputs, witness))
        h = hashlib.blake2b(digest_size=32)
        for root in (inputs.pre_state_root, inputs.post_state_root,
                     inputs.pre_shielded_root, inputs.post_shielded_root,
                     inputs.withdrawal_root, inputs.batch_hash):
            h.update(root)
        h.update(inputs.batch_id.to_bytes(8, "little"))
        return self.sp.BatchProof(inputs, h.digest() + b"\x00" * 224, 0)


def orchestrator(pkg, dev_mode=False, store=None, mode=None, prover=None,
                 settler=None):
    config = pkg.p.PipelineConfig(batch=pkg.b.BatchConfig(max_age_secs=3600))
    if mode is not None:
        config.prover_mode = getattr(pkg.p.ProverMode, mode)
    return pkg.p.PipelineOrchestrator(
        store=store, config=config, prover=prover or StubProver(pkg.sp),
        settler=settler or pkg.s.MockSettler(), dev_mode=dev_mode)


def drain(orch, timeout=20.0):
    """Tick until the prove and settle workers are both done."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        orch.tick()
        if not (orch.proving_in_flight or orch.batches.next_for_proving()
                or orch.settlement_pending):
            return
        time.sleep(0.005)
    raise AssertionError("pipeline did not drain in time")


def signed(pkg, seed, tx):
    tx.signature = pkg.cr.sign(seed, tx.signing_message())
    return tx


def run_script(pkg, store=None):
    """tests/test_sequencer.py's scripts in one run: deposits, signed
    transfers and withdrawals, the rejections, shielded transactions with a
    double spend inside a batch and after finalization, a fast withdrawal
    fronted by an LP. Returns the orchestrator and every submission's
    result."""
    tx = pkg.tx
    orch = orchestrator(pkg, store=store)
    res = [orch.submit(tx.Deposit(to=ALICE, amount=1000, l1_seq=1)),
           orch.submit(tx.Deposit(to=BOB, amount=50, l1_seq=2)),
           orch.submit(signed(pkg, ALICE_SEED, tx.Transfer(
               signer_pubkey=ALICE, to=BOB, amount=250, nonce=0))),
           orch.submit(tx.Transfer(signer_pubkey=ALICE, to=BOB, amount=10,
                                   nonce=1, signature=b"\x00" * 64)),
           orch.submit(signed(pkg, ALICE_SEED, tx.Transfer(
               signer_pubkey=ALICE, to=BOB, amount=10_000, nonce=1))),
           orch.submit(signed(pkg, ALICE_SEED, tx.Transfer(
               signer_pubkey=ALICE, to=BOB, amount=10, nonce=5))),
           orch.submit(signed(pkg, BOB_SEED, tx.Withdraw(
               from_=BOB, to_l1_address=L1, amount=100, nonce=0))),
           orch.submit(tx.Shielded(proof=b"\x00" * 324, nullifier=b"\x41" * 32,
                                   commitment=b"\x42" * 32,
                                   ciphertext=b"\xab" * 40)),
           orch.submit(tx.Shielded(proof=b"\x00" * 324, nullifier=b"\x41" * 32,
                                   commitment=b"\x43" * 32))]
    orch.seal()
    drain(orch)
    res.append(orch.submit(tx.Shielded(
        proof=b"\x00" * 324, nullifier=b"\x41" * 32,
        commitment=b"\x44" * 32)))
    res.append(orch.submit(tx.Shielded(
        proof=b"\x00" * 324, nullifier=b"\x51" * 32, commitment=b"\x52" * 32,
        ciphertext=b"\xcd" * 24)))
    res.append(orch.execute_fast_withdraw(signed(pkg, ALICE_SEED, tx.Withdraw(
        from_=ALICE, to_l1_address=L1, amount=100, nonce=1))))
    orch.fast_withdrawals.add_liquidity(b"\x0a" * 32, 10_000)
    res.append(orch.fast_withdrawals.quote(100))
    res.append(orch.execute_fast_withdraw(signed(pkg, ALICE_SEED, tx.Withdraw(
        from_=ALICE, to_l1_address=L1, amount=100, nonce=1))))
    res.append(orch.fast_withdrawals.outstanding)
    res.append(orch.submit(signed(pkg, ALICE_SEED, tx.Transfer(
        signer_pubkey=ALICE, to=BOB, amount=5, nonce=2))))
    orch.seal()
    drain(orch)
    return orch, [r if isinstance(r, (int, tuple)) else
                  (r.accepted, r.error) for r in res]


def _account_path(orch, account):
    path = orch.tree.path(account)
    return path and (path.siblings, list(path.path_indices))


def snapshot(orch) -> dict:
    """Everything the orchestrator keeps, in plain values."""
    batches = [{k: v.value if hasattr(v, "value") else v
                for k, v in vars(b).items()
                if k in ("id", "state", "pre_state_root", "post_state_root",
                         "pre_shielded_root", "post_shielded_root",
                         "settlement_sig", "error")}
               for b in orch.batches.sealed]
    shielded = orch.shielded.tree
    paths = [shielded.path(i) for i in range(shielded.next_index)]
    return {
        "roots": (orch.tree.root(), orch.shielded.root()),
        "accounts": [(vars(orch.get_account(a)), _account_path(orch, a))
                     for a in (ALICE, BOB, L1)],
        "paths": [(p.siblings, list(p.path_bits), p.position)
                  for p in paths],
        "batches": batches,
        "batch_records": orch.list_batch_records(),
        "txs": orch.list_txs(),
        "store": {cf: list(orch.store.scan(cf))
                  for cf in JST.COLUMN_FAMILIES},
        "withdrawals": [(w.id, w.state.value, w.batch_id, w.l1_signature,
                         w.amount) for w in orch.withdrawals.items.values()],
        "fast": (orch.fast_withdrawals.outstanding,
                 orch.fast_withdrawals.total_liquidity()),
        "settled": orch.settler.submitted,
        "proved": [(dataclasses.asdict(i), dataclasses.asdict(w))
                   for i, w in orch.prover.seen],
        "stats": dataclasses.asdict(orch.stats),
    }


def test_pipeline_scripts_match_jax():
    jorch, jres = run_script(JAX)
    torch_orch, tres = run_script(PORT)
    assert tres == jres
    assert [r[0] for r in tres[:9]] == [True, True, True, False, False,
                                        False, True, True, False]
    want, got = snapshot(jorch), snapshot(torch_orch)
    for key in want:
        assert got[key] == want[key], key
    assert len(got["settled"]) == 2 and got["stats"]["batches_settled"] == 2
    assert got["fast"] == (0, 10_000)


def test_encrypted_mempool_matches_jax():
    """Dev mode: a threshold-encrypted transfer decrypted at the next tick.
    Each pipeline's committee is its own (random) one; a transfer that the
    JAX SDK encrypted for the port's committee decrypts in the port, and
    both end in the same state."""
    payload = json.dumps({"from": ALICE.hex(), "to": BOB.hex(),
                          "amount": 77, "nonce": 0}).encode()
    snaps = []
    for pkg in (JAX, PORT):
        orch = orchestrator(pkg, dev_mode=True)
        orch.submit(pkg.tx.Deposit(to=ALICE, amount=300, l1_seq=1))
        # the JAX SDK encrypts for both committees
        orch.submit_encrypted(JTH.encrypt_for_mempool(payload, orch.committee))
        orch.submit_encrypted(pkg.th.EncryptedTx(b"\x00" * 32, b"junk", {}))
        orch.tick()
        assert not orch.mempool.queue
        orch.seal()
        drain(orch)
        assert orch.get_account(BOB).balance == 77
        snaps.append(snapshot(orch))
    assert snaps[1] == snaps[0]


def test_store_reads_jax_database(tmp_path):
    path = str(tmp_path / "zelana.db")
    jorch, _ = run_script(JAX, store=JST.Store(path))
    want = {cf: list(jorch.store.scan(cf)) for cf in JST.COLUMN_FAMILIES}
    views = (lambda o: [vars(o.get_account(a)) for a in (ALICE, BOB)],
             lambda o: o.list_txs(), lambda o: o.list_batch_records())
    want_views = [v(jorch) for v in views]
    jorch.store._shared.close()
    store = TST.Store(path)
    assert {cf: list(store.scan(cf)) for cf in TST.COLUMN_FAMILIES} == want
    assert sum(map(len, want.values())) > 10
    orch = orchestrator(PORT, store=store)
    assert [v(orch) for v in views] == want_views


def test_config_load_matches_jax(tmp_path, monkeypatch):
    toml = tmp_path / "zelana.toml"
    toml.write_text('db_path = "/var/zelana"\nhttp_port = 9000\n'
                    'prover_mode = "groth16"\nmock_prover = false\n'
                    'proving_key = "artifacts/l2_dummy_pk.npz"\n'
                    'batch_max_age_secs = 5.5\nunknown_key = 1\n')
    for env in list(os.environ):
        if env.startswith("ZL_"):
            monkeypatch.delenv(env)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("ZL_BATCH_MAX_TXS", "7")
    monkeypatch.setenv("ZL_DEV_MODE", "false")
    got = TCFG.ZelanaConfig.load(str(toml))
    want = JCFG.ZelanaConfig.load(str(toml))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.http_port == 9000 and got.batch_max_txs == 7
    assert not got.dev_mode


def test_orchestrator_needs_a_prover():
    with pytest.raises(ValueError, match="needs a prover"):
        TP.PipelineOrchestrator()


# ------------------------------------------------------------------- API


def _raw(port, path):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 headers={"Accept": "text/event-stream"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.status, resp.read().decode()


def _settle(port, count, timeout=20.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        _, stats = http(port, "GET", "/status/stats")
        if stats["batches_settled"] >= count:
            return
        time.sleep(0.02)
    raise AssertionError("no settlement")


def api_session(pkg) -> list:
    """One session against a package's API (dev mode): every route of
    start_api but the dispatcher's chunked prove (tests/test_torch_worker.py)
    and ownership proving with a prover (chip_smoke.py). Returns the
    answers, with the random parts (committee keys, job ids) taken out."""
    orch = orchestrator(pkg, dev_mode=True)
    service = pkg.p.PipelineService(orch).start()
    server, port = pkg.api.start_api(orch)
    out = []

    def q(method, path, body=None):
        out.append((method, path, http(port, method, path, body)))
        return out[-1][2][1]

    try:
        for path in ("/health", "/status/stats", "/status/batch",
                     "/nope", "/account/zz", "/v2/batch/x/status"):
            q("GET", path)
        q("POST", "/dev/deposit", {"to": ALICE.hex(), "amount": 500})
        h = q("POST", "/transfer", {"from": ALICE.hex(), "to": BOB.hex(),
                                    "amount": 50, "nonce": 0})["tx_hash"]
        q("POST", "/transfer", {"from": ALICE.hex(), "to": BOB.hex(),
                                "amount": 9_999, "nonce": 1})
        wd = q("POST", "/withdraw", {"from": ALICE.hex(),
                                     "to_l1_address": L1.hex(),
                                     "amount": 25, "nonce": 1})["tx_hash"]
        q("POST", "/shielded/submit", {"proof": "11" * 80,
                                       "nullifier": "01" * 32,
                                       "commitment": "02" * 32,
                                       "ciphertext": "ab" * 100})
        q("POST", "/shielded/delegated", {"nullifier": "03" * 32,
                                          "commitment": "04" * 32})
        q("POST", "/withdraw/fast/quote", {"amount": 100})
        q("POST", "/withdraw/fast/execute", {
            "from": ALICE.hex(), "to_l1_address": L1.hex(), "amount": 100,
            "nonce": 2})
        q("POST", "/withdraw/fast/register_lp", {"lp": "0a" * 32,
                                                 "amount": 10_000})
        q("POST", "/withdraw/fast/execute", {
            "from": ALICE.hex(), "to_l1_address": L1.hex(), "amount": 100,
            "nonce": 2})
        q("POST", "/account", {"account_id": ALICE.hex()})
        q("GET", "/status/batch")
        q("POST", "/dev/seal", {})
        _settle(port, 1)
        for path in ("/status/stats", "/status/roots", "/status/batch",
                     f"/account/{BOB.hex()}", "/shielded/root",
                     "/shielded/merkle_path/0", "/shielded/merkle_path/5"):
            q("GET", path)
        for path, body in (("/account", {"account_id": ALICE.hex()}),
                           ("/shielded/merkle_path", {"position": 1}),
                           ("/shielded/scan", {}),
                           ("/shielded/scan", {"from_position": 1}),
                           ("/tx", {"tx_hash": h}),
                           ("/tx", {"tx_hash": "00" * 32}),
                           ("/txs", {"limit": 10}),
                           ("/batch", {"batch_id": 0}),
                           ("/batch", {"batch_id": 9}),
                           ("/batches", {}),
                           ("/withdraw/status", {"tx_hash": wd}),
                           ("/withdraw/status", {"tx_hash": "00" * 32}),
                           ("/v2/ownership/prove", {}),
                           ("/nope", {})):
            q("POST", path, body)
        committee = q("GET", "/encrypted/committee")
        members = committee.pop("members")
        assert [m["index"] for m in members] == [1, 2, 3, 4, 5]
        etx = JTH.encrypt_for_mempool(json.dumps({
            "from": ALICE.hex(), "to": BOB.hex(), "amount": 77,
            "nonce": 3}).encode(), orch.committee)
        q("POST", "/encrypted/submit", {
            "tx_id": etx.tx_id.hex(), "ciphertext": etx.ciphertext.hex(),
            "encrypted_shares": {str(k): v.hex()
                                 for k, v in etx.encrypted_shares.items()}})
        out[-1][2][1]["tx_id"] = "random"
        deadline = time.time() + 20
        while orch.mempool.queue:  # the next tick decrypts it
            assert time.time() < deadline, "mempool not drained"
            time.sleep(0.02)
        with orch._lock:  # held by the tick until the drain is done
            pass
        q("POST", "/admin/pause", {})
        q("GET", "/status/stats")
        q("POST", "/admin/resume", {})
        answer = q("POST", "/v2/batch/prove", {})
        job, answer["job_id"] = answer["job_id"], "uuid"
        deadline = time.time() + 20
        while http(port, "GET", f"/v2/batch/{job}/status")[1][
                "status"] != "done":
            assert time.time() < deadline, "prove job not done"
            time.sleep(0.02)
        out.append(("SSE", _raw(port, f"/v2/batch/{job}/status?stream=1")))
        out.append(("GET", "proof", http(port, "GET",
                                          f"/v2/batch/{job}/proof")))
        _settle(port, 2)
        for path in (f"/account/{BOB.hex()}", "/status/stats",
                     "/status/roots"):
            q("GET", path)
        q("POST", "/batches", {})
        q("POST", "/txs", {})
    finally:
        server.shutdown()
        server.server_close()
        service.stop()
    return out


def test_api_answers_match_jax():
    want = api_session(JAX)
    got = api_session(PORT)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == w, w[:2]
    answers = {(m, p): a for m, p, a in (x for x in got if len(x) == 3)}
    assert answers[("GET", f"/account/{BOB.hex()}")] == (
        200, {"balance": 127, "nonce": 0})


# ------------------------------------------------------------ GROTH16 mode


@pytest.fixture(scope="module")
def vector():
    with open(os.path.join(TESTDATA, "pipeline_l2_proof.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def l2_key():
    from zelana_tpu_torch.groth16.keys import ProvingKey

    return ProvingKey.load_npz(L2_KEY)


class Replay(StubProver):
    """Hands the pipeline the recorded proof of the batch it proves."""

    def __init__(self, proof_hex):
        super().__init__(TSP)
        self.proof = bytes.fromhex(proof_hex)

    def prove(self, inputs, witness):
        self.seen.append((inputs, witness))
        return TSP.BatchProof(inputs, self.proof, 0)


def check_served(served, seen, settler, vector):
    inputs, witness = seen
    assert served["batch"].id == vector["batch_id"]
    assert {k: v.hex() if isinstance(v, bytes) else v
            for k, v in vars(inputs).items()} == vector["inputs"]
    assert [[t.signer_pubkey.hex(), t.to.hex(), t.amount, t.nonce]
            for t in witness.transactions] == vector["transfers"]
    assert [[a.hex(), b] for a, b in witness.initial_accounts.items()] == (
        vector["initial_accounts"])
    assert witness.shielded_commitments == []
    assert served["batch"].proof.proof_bytes.hex() == vector["proof_bytes"]
    assert settler.inner.submitted[0].hex() == vector["submit_batch"]
    assert served["batch"].settlement_sig == vector["signature"]
    for key in ("roots", "accounts", "batch_record"):
        assert served[key] == vector[key], key


def test_groth16_mode_matches_vector(vector, l2_key):
    """The port's pipeline in GROTH16 mode folds the recorded public inputs
    and witness, and its on-chain verifier gate settles the recorded proof
    into the recorded SubmitBatch bytes."""
    prover = Replay(vector["proof_bytes"])
    settler = TS.OnchainVerifyingSettler(l2_key.vk)
    orch = orchestrator(PORT, dev_mode=True, mode="GROTH16", prover=prover,
                        settler=settler)
    served = serve_l2_batch(orch, TAPI.start_api, TP.PipelineService,
                            TAT.AccountState, timeout=120)
    check_served(served, prover.seen[0], settler, vector)
    proof = served["batch"].proof
    for i in (0, 100, 255):
        bad = bytearray(proof.proof_bytes)
        bad[i] ^= 1
        with pytest.raises(ValueError, match="verification failed"):
            TS.OnchainVerifyingSettler(l2_key.vk).submit(
                TSP.BatchProof(proof.public_inputs, bytes(bad), 0))


@pytest.mark.skipif(not os.environ.get("ZELANA_SLOW_TESTS"),
                    reason="a Groth16 proof on the CPU takes over a minute")
def test_groth16_pipeline_proves_vector_on_cpu(vector, l2_key):
    prover = TSP.Groth16Prover(l2_key, device="cpu")
    seen = []
    prove = prover.prove
    prover.prove = lambda i, w: seen.append((i, w)) or prove(i, w)
    settler = TS.OnchainVerifyingSettler(l2_key.vk)
    orch = orchestrator(PORT, dev_mode=True, mode="GROTH16", prover=prover,
                        settler=settler)
    served = serve_l2_batch(orch, TAPI.start_api, TP.PipelineService,
                            TAT.AccountState)
    check_served(served, seen[0], settler, vector)


def test_native_mimc_raises_when_gxx_fails(tmp_path, monkeypatch):
    """The account tree's MiMC library has no Python fallback in the port:
    a failed build raises (the JAX package falls back to Python)."""
    from zelana_tpu_torch import native
    from zelana_tpu_torch.sequencer import native as seq_native

    gxx = tmp_path / "bin" / "g++"
    gxx.parent.mkdir()
    gxx.write_text("#!/bin/sh\necho 'g++: no compiler here' >&2\nexit 1\n")
    gxx.chmod(0o755)
    monkeypatch.setenv("PATH", str(gxx.parent))
    monkeypatch.setattr(native, "BUILD", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_LIBS", {})
    seq_native.load.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed for mimc.cpp"):
            seq_native.hash2_be(b"\x00" * 32, b"\x00" * 32)
    finally:
        seq_native.load.cache_clear()
    monkeypatch.undo()
    assert seq_native.hash2_be(b"\x00" * 32, b"\x00" * 32) == (
        JAT.native.hash2_be(b"\x00" * 32, b"\x00" * 32))
