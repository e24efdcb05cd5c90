"""The port's command line (zelana_tpu_torch.cli) and the tools it drives
(tools.explorer, tools.e2e, tools.bench_udp) against the JAX package's, on
the CPU. Equality is exact: printed lines, written files, proofs.

`test` prints the JAX lines; `test --zk --device cpu` keygens and proves
the `_SevenInput` relation on the CPU, and its key, proof and SubmitBatch
instruction equal testdata/cli_vectors.json, which
tools/record_service_vectors.py cli recorded with the JAX command line.
`deploy` writes the JAX descriptor, `verify` prints the JAX lines on the
recorded L2 proof, `genkey` writes the JAX format. `dev` boots as a
process over a Groth16 key on the CPU, takes an `airdrop`, and exits on
SIGINT with its shutdown batch refused on the host. The key/witness
mismatch: a witness that does not fit the key is refused before any
launch. ZELANA_SLOW_TESTS=1 adds `keygen --seed 0` and `prove` of the L2
circuit on the CPU against the recorded digests and proof (about 70 s
each).
"""

import base64
import contextlib
import hashlib
import io
import json
import os
import re
import signal
import subprocess
import sys
import time

import pytest
import torch

import zelana_tpu.cli as JCLI
import zelana_tpu_torch.cli as TCLI

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTDATA = os.path.join(ROOT, "zelana_tpu_torch", "testdata")
L2_KEY = os.path.join(ROOT, "artifacts", "l2_dummy_pk.npz")
SLOW = pytest.mark.skipif(not os.environ.get("ZELANA_SLOW_TESTS"),
                          reason="set ZELANA_SLOW_TESTS=1 (about 70 s each)")


def run(main, argv):
    """(return code, printed lines) of one in-process command."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue().splitlines()


@pytest.fixture(scope="module")
def vectors():
    with open(os.path.join(TESTDATA, "cli_vectors.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def l2_proof():
    with open(os.path.join(TESTDATA, "l2_dummy_proof.json")) as f:
        return json.load(f)


def test_test_command_matches_jax():
    want = run(JCLI.main, ["test", "--timeout", "30"])
    got = run(TCLI.main, ["test", "--timeout", "30"])
    assert got == want
    assert got[0] == 0 and got[1][-1] == "e2e: OK"
    assert len(got[1]) == 9 and all("[PASS]" in x for x in got[1][:-1])


def test_test_zk_on_cpu_matches_vector(monkeypatch, vectors):
    """`--device cpu test --zk`: the SubmitBatch CPI verifies the port's
    own keygen and proof, equal to the JAX command's."""
    from zelana_tpu_torch.groth16 import setup
    from zelana_tpu_torch.sequencer import bridge_program as bp

    seen = {"keys": [], "submits": []}
    keygen, process = setup.keygen, bp.BridgeSVM.process

    def keep_keygen(*a, **k):
        seen["keys"].append(keygen(*a, **k))
        return seen["keys"][-1]

    def keep_submit(self, ix):
        if ix.program_id == bp.BRIDGE_PROGRAM_ID and ix.data[:1] == b"\x03":
            seen["submits"].append(ix.data)
        return process(self, ix)

    monkeypatch.setattr(setup, "keygen", keep_keygen)
    monkeypatch.setattr(bp.BridgeSVM, "process", keep_submit)
    rc, lines = run(TCLI.main, ["--device", "cpu", "test", "--zk"])
    want = vectors["test_zk"]
    assert rc == 0 and lines[:-2] + lines[-1:] == want["lines"]
    assert lines[-2].startswith(
        "  [PASS] SubmitBatch Groth16 CPI verified (")
    (pk,), (submit,) = seen["keys"], seen["submits"]
    assert hashlib.sha256(pk.serialize_compressed()).hexdigest() == (
        want["key_sha256"])
    assert submit[57:57 + 256].hex() == want["proof"]
    assert submit.hex() == want["submit_batch"]


@pytest.mark.parametrize("argv", [
    [],
    ["--network", "devnet", "--domain", "ab" * 32, "--authority", "cd" * 32],
    ["--vk", "vk.bin"],
], ids=["default", "devnet", "vk_file"])
def test_deploy_matches_jax(tmp_path, monkeypatch, vectors, argv):
    from zelana_tpu_torch.groth16.keys import ProvingKey

    files = {}
    for name, main in (("jax", JCLI.main), ("port", TCLI.main)):
        d = tmp_path / name
        d.mkdir()
        (d / "vk.bin").write_bytes(
            ProvingKey.load_npz(L2_KEY).vk.serialize_compressed())
        monkeypatch.chdir(d)
        files[name] = run(main, ["deploy", *argv]), (
            d / "deployment.json").read_bytes()
    assert files["port"] == files["jax"]
    (rc, lines), desc = files["port"]
    assert rc == 0 and lines[-1 if argv[:1] != ["--network"] else -2] == (
        "deployment descriptor -> ./deployment.json")
    if not argv:
        assert desc.decode() == vectors["deploy"]["descriptor"]


@pytest.mark.parametrize("with_vk", ["right_inputs", "wrong_inputs", "none"])
def test_verify_matches_jax(tmp_path, l2_proof, with_vk):
    from zelana_tpu_torch.groth16.keys import ProvingKey

    proof = tmp_path / "proof.json"
    proof.write_text(json.dumps({"proof": base64.b64encode(bytes.fromhex(
        l2_proof["proof"])).decode()}))
    vk = tmp_path / "vk.json"
    vk.write_text(json.dumps({"verifying_key": base64.b64encode(
        ProvingKey.load_npz(L2_KEY).vk.serialize_compressed()).decode()}))
    inputs = list(l2_proof["public_inputs"])
    if with_vk == "wrong_inputs":
        inputs[0] = str(int(inputs[0]) + 1)
    argv = ["verify", "--proof", str(proof)]
    if with_vk != "none":
        argv += ["--vk", str(vk), "--inputs", ",".join(inputs)]
    got = run(TCLI.main, argv)
    assert got == run(JCLI.main, argv)
    assert got[1][:3] == [f"  {c} on curve+subgroup: True" for c in "abc"]
    if with_vk != "none":
        assert got[1][3] == (f"  pairing check: "
                             f"{with_vk == 'right_inputs'}")


def test_prove_builds_the_recorded_circuit(l2_proof, vectors):
    """`prove`'s circuit is the one testdata/l2_dummy_proof.json proves
    (its public inputs), so `prove --pk <keygen --seed 0> --batch-id 1`
    gives that proof (the JAX command did, tools/record_service_vectors.py
    cli)."""
    from zelana_tpu_torch.groth16.prove import public_inputs_of

    assert [str(v) for v in public_inputs_of(TCLI.demo_circuit())] == (
        l2_proof["public_inputs"])
    assert vectors["prove"] == {"batch_id": 1,
                                "proof": "l2_dummy_proof.json"}


def test_genkey_writes_the_jax_format(tmp_path):
    from zelana_tpu.sdk.keypair import ZelanaKeypair as JKP
    from zelana_tpu_torch.sdk.keypair import ZelanaKeypair as TKP

    docs = {}
    for name, main in (("jax", JCLI.main), ("port", TCLI.main)):
        path = str(tmp_path / f"{name}.json")
        rc, lines = run(main, ["genkey", path])
        assert rc == 0 and oct(os.stat(path).st_mode)[-3:] == "600"
        docs[name] = json.load(open(path))
        assert lines == [f"keypair -> {path}",
                         f"pubkey: {docs[name]['pubkey']}",
                         f"privacy pk: {docs[name]['privacy_pk']}"]
    assert list(docs["port"]) == list(docs["jax"])
    doc = docs["port"]
    for cls in (JKP, TKP):
        kp = cls(bytes.fromhex(doc["signing_seed"]),
                 bytes.fromhex(doc["privacy_sk"]))
        assert (kp.pubkey.hex(), kp.privacy_pk.hex()) == (
            doc["pubkey"], doc["privacy_pk"])


@pytest.fixture
def clean_env(tmp_path, monkeypatch):
    """No ZL_* variable and no config.toml in reach."""
    for var in list(os.environ):
        if var.startswith("ZL_"):
            monkeypatch.delenv(var)
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.chdir(tmp_path)
    return tmp_path


def test_dev_refuses_the_default_config(clean_env, capsys):
    with pytest.raises(ValueError, match="proves with Groth16 only"):
        TCLI.main(["--device", "cpu", "dev", "--ephemeral"])
    assert capsys.readouterr().err.startswith(
        "dev: the port proves with Groth16 only: prover_mode 'mock'")


@pytest.fixture(scope="module")
def cubic_key_file(tmp_path_factory):
    """A compressed proving key of the cubic circuit (x^3 + x + 5 == 35),
    made on the CPU."""
    from zelana_tpu_torch.groth16.setup import keygen

    class Cubic:
        def generate_constraints(self, cs):
            out = cs.new_input(35)
            x = cs.new_witness(3)
            ((x * x) * x + x + cs.constant(5)).enforce_equal(out)

    path = tmp_path_factory.mktemp("keys") / "cubic.key"
    path.write_bytes(keygen(Cubic(), seed=0,
                            device="cpu").serialize_compressed())
    return str(path)


def test_dev_airdrop_and_sigint(clean_env, cubic_key_file):
    """`--device cpu dev --ephemeral` as a process with a Groth16 config:
    it prints its prover, `airdrop` lands against it, and on SIGINT its
    shutdown seal is proved, refused on the host (the deposit-only batch
    does not satisfy the L2 circuit) and the process exits 0."""
    env = dict(os.environ, ZL_PROVER_MODE="groth16", ZL_MOCK_PROVER="0",
               ZL_PROVING_KEY=cubic_key_file, OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT, PYTHONUNBUFFERED="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "zelana_tpu_torch.cli", "--device", "cpu",
         "dev", "--ephemeral"], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env, cwd=str(clean_env),
        preexec_fn=lambda: signal.signal(signal.SIGINT, signal.SIG_DFL))
    try:
        lines = [proc.stdout.readline().rstrip() for _ in range(2)]
        assert lines[0] == "prover: Groth16Prover (mode=groth16)", lines
        url = lines[1].split(": ", 1)[1]
        rc, out = run(TCLI.main, ["airdrop", "5a" * 32, "--amount", "1234",
                                  "--url", url])
        assert rc == 0 and out == [
            f"airdropped 1234 -> {'5a' * 8}... (balance 1234)"]
        t0 = time.time()
        proc.send_signal(signal.SIGINT)
        rest, _ = proc.communicate(timeout=30)
        assert proc.returncode == 0, rest
        assert time.time() - t0 < 16
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert rest.splitlines()[0] == "shutting down (sealing pending batch)..."
    assert re.match(r"last batch \d+: FAILED \(prove failed: constraint "
                    r"\d+ unsatisfied", rest.splitlines()[1]), rest


# ------------------------------------------------ the key/witness mismatch


class SevenInput:
    """`cli test --zk`'s relation: the L2 key's 7 public inputs, a witness
    of 11 variables where the key has 5,536."""

    def __init__(self, vals):
        self.vals = vals

    def generate_constraints(self, cs):
        ins = [cs.new_input(v) for v in self.vals]
        (ins[0] * ins[1]).enforce_equal(
            cs.new_witness(self.vals[0] * self.vals[1]))
        (ins[2] + ins[3] + ins[4] + ins[5] + ins[6]).enforce_equal(
            cs.new_witness(sum(self.vals[2:])))


def test_prove_refuses_a_witness_that_does_not_fit(monkeypatch):
    """Raised on the host before the witness map or any MSM: the JAX
    package raises an IndexError only after its witness map ran
    (test_jax_mismatch_raises_after_its_witness_map)."""
    from zelana_tpu_torch.groth16 import prove as P
    from zelana_tpu_torch.groth16.keys import ProvingKey

    def launched(*a, **k):
        raise AssertionError("a device stage ran")

    monkeypatch.setattr(P, "witness_map_dispatch", launched)
    monkeypatch.setattr(P, "prepare_queries", launched)
    pk = ProvingKey.load_npz(L2_KEY)
    with pytest.raises(ValueError, match=r"key / witness mismatch: the "
                       r"witness has \(instances, variables, h terms\) = "
                       r"\(8, 11, 15\), the key \(8, 5536, 8191\)"):
        P.prove(pk, SevenInput(list(range(1, 8))), batch_id=1, device="cpu")
    with pytest.raises(ValueError, match="key / witness mismatch"):
        P.check_fits(pk, 8, 5536, 4000)  # the right width, a short domain
    P.check_fits(pk, 8, 5536, 8000)


def deposit_only_batch(pkg, kw):
    """`dev`'s shutdown seal under a Groth16 config: one airdrop deposit,
    proved with the L2 key."""
    def m(name):
        return __import__(f"{pkg}.{name}", fromlist=["x"])

    pk = m("groth16.keys").ProvingKey.load_npz(L2_KEY)
    pl, b = m("sequencer.pipeline"), m("sequencer.batch")
    orch = pl.PipelineOrchestrator(
        config=pl.PipelineConfig(batch=b.BatchConfig(max_age_secs=3600)),
        prover=m("sequencer.prover_service").Groth16Prover(pk, **kw),
        dev_mode=True)
    orch.submit(m("sequencer.transactions").Deposit(
        to=b"\x5a" * 32, amount=1234, l1_seq=0))
    orch.seal()
    deadline = time.time() + 60
    batch = orch.batches.sealed[0]
    while batch.error is None and batch.proof is None:
        assert time.time() < deadline
        orch.tick()
        time.sleep(0.02)
    return batch.state.name, batch.error


def test_shutdown_batch_is_refused_on_the_host(monkeypatch):
    from zelana_tpu_torch.groth16 import prove as P

    def launched(*a, **k):
        raise AssertionError("a device stage ran")

    monkeypatch.setattr(P, "witness_map_dispatch", launched)
    got = deposit_only_batch("zelana_tpu_torch", {"device": "cpu"})
    assert got == deposit_only_batch("zelana_tpu", {})
    assert got[0] == "FAILED" and got[1].startswith(
        "prove failed: constraint ") and "unsatisfied" in got[1]


@SLOW
def test_jax_mismatch_raises_after_its_witness_map():
    from zelana_tpu.groth16.keys import ProvingKey
    from zelana_tpu.groth16.prove import prove

    with pytest.raises(IndexError):
        prove(ProvingKey.load_npz(L2_KEY), SevenInput(list(range(1, 8))),
              batch_id=1)


# ------------------------------------------------------------------ tools


def explorer_store(store_cls):
    s = store_cls()
    s.put("accounts", b"\xab" * 32,
          (500).to_bytes(8, "little") + (3).to_bytes(8, "little"))
    s.put("accounts", b"\xac" * 32, (7).to_bytes(8, "little"))
    s.put("tx_index", b"\x01" * 32, json.dumps(
        {"kind": "transfer", "status": "finalized", "batch_id": 7}).encode())
    s.put("batches", (7).to_bytes(8, "little"), json.dumps(
        {"id": 7, "state": "finalized", "txs": 2}).encode())
    s.put("nullifiers", b"\x7b" * 32, b"\x01")
    return s


def test_explorer_matches_jax():
    import urllib.request

    from zelana_tpu.sequencer.store import Store as JStore
    from zelana_tpu.tools import explorer as JE
    from zelana_tpu_torch.sequencer.store import Store as TStore
    from zelana_tpu_torch.tools import explorer as TE

    want = JE.snapshot(explorer_store(JStore))
    assert TE.snapshot(explorer_store(TStore)) == want
    assert TE.snapshot(explorer_store(TStore), limit=1)["accounts"] == (
        JE.snapshot(explorer_store(JStore), limit=1)["accounts"])
    pages = []
    for mod, store_cls in ((JE, JStore), (TE, TStore)):
        server, port = mod.start_explorer(explorer_store(store_cls))
        try:
            pages.append([urllib.request.urlopen(
                f"http://127.0.0.1:{port}{p}").read() for p in ("/data", "/")])
        finally:
            server.shutdown()
            server.server_close()
    assert pages[1] == pages[0] and json.loads(pages[1][0]) == want


def test_e2e_tool_matches_jax():
    from zelana_tpu.tools import e2e as JE2E
    from zelana_tpu_torch.tools import e2e as TE2E

    got = run(lambda argv: TE2E.main(), [])
    assert got == run(lambda argv: JE2E.main(), [])
    assert got[0] == 0 and got[1][-1] == "e2e OK"


def test_bench_udp_on_cpu():
    from zelana_tpu_torch.tools import bench_udp

    rc, lines = run(bench_udp.main, ["--count", "20", "--device", "cpu"])
    assert rc == 0 and lines[0].startswith("udp ingest: 20/20 accepted in ")


# ------------------------------------------- the L2 circuit, slow on the CPU


@SLOW
def test_keygen_and_prove_match_vectors(tmp_path, vectors, l2_proof):
    pk, vk = str(tmp_path / "pk"), str(tmp_path / "vk")
    rc, lines = run(TCLI.main, ["--device", "cpu", "keygen", "--seed", "0",
                                "--pk-out", pk, "--vk-out", vk])
    want = vectors["keygen"]
    assert lines[-1] == want["vk_hash_line"]
    for path, key in ((pk, "pk_sha256"), (vk, "vk_sha256")):
        assert hashlib.sha256(open(path, "rb").read()).hexdigest() == (
            want[key])
    out = str(tmp_path / "proof.json")
    rc, lines = run(TCLI.main, ["--device", "cpu", "prove", "--pk", pk,
                                "--batch-id", "1", "--out", out])
    assert ", verified: True, -> " in lines[-1]
    assert base64.b64decode(json.load(open(out))["proof"]).hex() == (
        l2_proof["proof"])
