"""Record the prover services' test vectors with the JAX package on the CPU.

    JAX_PLATFORMS=cpu python tools/record_service_vectors.py [l2] [ownership]
        [cubic] [cubic_many] [pipeline] [cli] [shielded] [jac_msm]

- ``zelana_tpu_torch/testdata/l2_batch_proof.json``: the JAX
  ``sequencer.prover_service.Groth16Prover`` with
  ``artifacts/l2_dummy_pk.npz`` proves the batch that
  ``L2BlockCircuit.dummy()`` describes (accounts 0x01.. = 1000 and
  0x02.. = 0, one transfer of 100) as batch 1, its roots the circuit's own
  folds for batch_id 1; the batch's public inputs and witness, the 256
  proof bytes and the circuit's public input values.
- ``zelana_tpu_torch/testdata/ownership_proof.json``: the JAX
  ``runtime.ownership_api.OwnershipProver().prove(12345, 777, 999, 5)``
  (seed-0 keygen of the ownership circuit, then the proof); every field of
  its answer but the proving time.
- ``zelana_tpu_torch/testdata/cubic_proof.json``: the JAX
  ``groth16.prove.prove`` of the cubic circuit (x^3 + x + 5 == 35, x = 3)
  as batch 7 with its seed-0 key (``groth16.setup.keygen``), and the
  SHA-256 of that key's compressed serialization.
- ``zelana_tpu_torch/testdata/cubic_many_proofs.json``: with the same
  key, the JAX ``prove`` of the cubic circuit at x = 3 as batches 7, 8 and
  9, and its ``prove_many`` of x = 5 as batches 11 and 12; compressed
  proofs.
- ``zelana_tpu_torch/testdata/pipeline_l2_proof.json``: the served L2
  batch. The JAX ``sequencer.pipeline.PipelineOrchestrator`` in GROTH16
  mode, dev mode, proving with ``Groth16Prover`` over
  ``artifacts/l2_dummy_pk.npz`` and settling through
  ``OnchainVerifyingSettler``, runs under ``PipelineService`` and
  ``sequencer.api.start_api``; account 0x01.. is funded with 1000 straight
  into the store and the tree, then ``POST /transfer`` (0x01.. to 0x02..,
  100, nonce 0) and ``POST /dev/seal``, and the batch settles. Recorded:
  the batch id, the folded public inputs, the witness, the 256 proof
  bytes, the SubmitBatch instruction bytes, and the roots and balances
  after settlement.

- ``zelana_tpu_torch/testdata/cli_vectors.json``: the JAX command line
  (``zelana_tpu.cli.main``) in a temporary directory: the SHA-256 of the
  two files ``keygen --seed 0`` writes and the vk hash it prints; the
  descriptor ``deploy`` writes on the committed key; from ``test --zk``,
  the SHA-256 of the ``_SevenInput`` proving key (seed 0), the verifier
  account it stores, the 256 proof bytes and the SubmitBatch instruction
  (caught on ``BridgeSVM.store_vk`` and ``BridgeSVM.process``), and its
  PASS lines; and the proof ``prove --pk <keygen's file> --batch-id 1``
  writes, which must be ``l2_dummy_proof.json``'s.

- ``zelana_tpu_torch/testdata/shielded_proof.json``: the shielded
  transfer (``circuits/shielded.py``, 2 inputs, 2 outputs, depth 32) of
  ``SHIELDED``: two notes of spending key 111 (values 500 and 300,
  randomness 7 and 8) inserted into an empty ``NoteTree``, spent into 490
  to key 222's public key and 300 back to key 111's, fee 10. The JAX
  ``groth16.setup.keygen(seed=0)`` and ``groth16.prove.prove`` as batch 1:
  the constants, the public inputs, the SHA-256 of the key's compressed
  serialization and its compressed verifying key, the compressed proof
  and its 256 Solana bytes.

- ``zelana_tpu_torch/testdata/jac_msm_words.json``: the (C, 1) Jacobian
  words of the JAX ``ops.msm._msm`` (the segmented-scan MSM under
  ``msm_g1`` / ``msm_g2``) on the inputs of
  tests/test_torch_curve_ops.py::test_jacobian_msm_matches_host (the
  inputs of tests/test_msm.py: 24 G1 points with a zero scalar, an
  identity point and P + (-P); one G1 point; four G2 points), each padded
  as ``msm_g1`` pads it; rows X | Y | Z (G2: X.c0, X.c1, ...) of 32-bit
  words, about a minute of XLA on the CPU.

The port is held against these files by tests/test_torch_prover_service.py,
tests/test_torch_sharded.py, tests/test_torch_sequencer.py,
tests/test_torch_cli.py, tests/test_torch_shielded.py and
tests/test_torch_concurrent.py (on the CPU) and
by chip_smoke.py's ``services``, ``sequencer``, ``cli`` and ``shielded``
phases (on the card); the Jacobian MSM's words by
tests/test_torch_curve_ops.py.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
TESTDATA = os.path.join(ROOT, "zelana_tpu_torch", "testdata")
CMD = "JAX_PLATFORMS=cpu python tools/record_service_vectors.py"

L2_BATCH_ID = 1
OWNERSHIP_WITNESS = (12345, 777, 999, 5)


def dummy_batch(block, sp, tx, batch_id: int):
    """(BatchPublicInputs, BatchWitness) of the L2 dummy batch, built from
    the modules given (the JAX package's or the port's)."""
    c = block.L2BlockCircuit.dummy()
    t = c.transactions[0]
    final = block.apply_transfers(c.initial_accounts, c.transactions)
    zero = b"\x00" * 32
    inputs = sp.BatchPublicInputs(
        pre_state_root=block.compute_state_root(batch_id, c.initial_accounts),
        post_state_root=block.compute_state_root(batch_id, final),
        pre_shielded_root=zero, post_shielded_root=zero,
        withdrawal_root=block.compute_withdrawal_root([]),
        batch_hash=block.compute_batch_hash(batch_id, c.transactions),
        batch_id=batch_id)
    witness = sp.BatchWitness(
        transactions=[tx.Transfer(t.sender_pk, t.recipient_pk, t.amount, 0)],
        initial_accounts=dict(c.initial_accounts))
    return inputs, witness


def record_l2() -> None:
    from zelana_tpu.circuits import l2_block
    from zelana_tpu.groth16.keys import ProvingKey
    from zelana_tpu.sequencer import prover_service as sp
    from zelana_tpu.sequencer import transactions as tx

    pk = ProvingKey.load_npz(os.path.join(ROOT, "artifacts",
                                          "l2_dummy_pk.npz"))
    prover = sp.Groth16Prover(pk)
    inputs, witness = dummy_batch(l2_block, sp, tx, L2_BATCH_ID)
    proof = prover.prove(inputs, witness)
    assert prover.verify(proof)
    out = {
        "batch": "circuits/l2_block.py L2BlockCircuit.dummy() as a batch, "
                 "roots folded for its batch_id",
        "key": "artifacts/l2_dummy_pk.npz",
        "batch_id": L2_BATCH_ID,
        "inputs": {k: v.hex() if isinstance(v, bytes) else v
                   for k, v in vars(inputs).items()},
        "transfers": [[t.signer_pubkey.hex(), t.to.hex(), t.amount, t.nonce]
                      for t in witness.transactions],
        "initial_accounts": [[pk.hex(), bal] for pk, bal
                             in witness.initial_accounts.items()],
        "public_inputs": [str(v) for v in sp.public_input_values(inputs)],
        "proof_bytes": proof.proof_bytes.hex(),
        "recorded_with": f"{CMD} l2 (zelana_tpu.sequencer.prover_service."
                         "Groth16Prover.prove)",
    }
    _write("l2_batch_proof.json", out)


def record_ownership() -> None:
    from zelana_tpu.runtime.ownership_api import OwnershipProver

    res = OwnershipProver().prove(*OWNERSHIP_WITNESS)
    res.pop("proving_time_ms")
    out = {"witness": list(OWNERSHIP_WITNESS), **res,
           "recorded_with": f"{CMD} ownership (zelana_tpu.runtime."
                            "ownership_api.OwnershipProver().prove(12345, "
                            "777, 999, 5))"}
    _write("ownership_proof.json", out)


class Cubic:
    """x^3 + x + 5 == out (tests/test_torch_prove.py's circuit)."""

    def __init__(self, x):
        self.x = x

    def generate_constraints(self, cs):
        out = cs.new_input(self.x ** 3 + self.x + 5)
        x = cs.new_witness(self.x)
        ((x * x) * x + x + cs.constant(5)).enforce_equal(out)


CUBIC_X, CUBIC_BATCH_ID = 3, 7


def record_cubic() -> None:
    import hashlib

    from zelana_tpu.groth16.prove import prove
    from zelana_tpu.groth16.setup import keygen
    from zelana_tpu.groth16.verify import verify

    pk = keygen(Cubic(CUBIC_X), seed=0)
    proof = prove(pk, Cubic(CUBIC_X), batch_id=CUBIC_BATCH_ID)
    out_value = CUBIC_X ** 3 + CUBIC_X + 5
    assert verify(pk.vk, proof, [out_value])
    out = {
        "circuit": "x^3 + x + 5 == out", "x": CUBIC_X,
        "public_inputs": [str(out_value)], "batch_id": CUBIC_BATCH_ID,
        "key_sha256": hashlib.sha256(pk.serialize_compressed()).hexdigest(),
        "proof": proof.serialize_compressed().hex(),
        "recorded_with": f"{CMD} cubic (zelana_tpu.groth16.prove.prove "
                         "with zelana_tpu.groth16.setup.keygen(seed=0))",
    }
    _write("cubic_proof.json", out)


CUBIC_MANY = {"prove": (3, (7, 8, 9)), "prove_many": (5, (11, 12))}


def record_cubic_many() -> None:
    from zelana_tpu.groth16.prove import prove, prove_many
    from zelana_tpu.groth16.setup import keygen
    from zelana_tpu.groth16.verify import verify

    pk = keygen(Cubic(CUBIC_X), seed=0)
    x, ids = CUBIC_MANY["prove"]
    single = [prove(pk, Cubic(x), batch_id=b) for b in ids]
    mx, mids = CUBIC_MANY["prove_many"]
    many = prove_many(pk, [(Cubic(mx), b) for b in mids])
    for p, v in [(p, x) for p in single] + [(p, mx) for p in many]:
        assert verify(pk.vk, p, [v ** 3 + v + 5])
    out = {
        "circuit": "x^3 + x + 5 == out",
        "prove": {"x": x, "batch_ids": list(ids),
                  "proofs": [p.serialize_compressed().hex() for p in single]},
        "prove_many": {"x": mx, "batch_ids": list(mids),
                       "proofs": [p.serialize_compressed().hex()
                                  for p in many]},
        "recorded_with": f"{CMD} cubic_many (zelana_tpu.groth16.prove.prove "
                         "and prove_many with zelana_tpu.groth16.setup."
                         "keygen(seed=0))",
    }
    _write("cubic_many_proofs.json", out)


PIPELINE_FUNDED = (b"\x01" * 32, 1000)
PIPELINE_TRANSFER = {"from": "01" * 32, "to": "02" * 32, "amount": 100,
                     "nonce": 0}


def http(port: int, method: str, path: str, body=None):
    """(status, JSON answer) of one request to a local API."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method=method)
    if data:
        req.add_header("Content-Type", "application/json")
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def serve_l2_batch(orch, start_api, service_cls, state_cls,
                   timeout: float = 1800.0) -> dict:
    """Serve the L2 dummy batch through a package's pipeline and API (the
    orchestrator, `start_api`, PipelineService and AccountState given are
    all the JAX package's or all the port's): fund, transfer, seal, wait
    for settlement. Returns the settled batch and what the API answers."""
    import time

    pk, balance = PIPELINE_FUNDED
    orch._persist_account(pk, state_cls(balance, 0))
    orch.tree.insert(pk, state_cls(balance, 0))
    service = service_cls(orch).start()
    server, port = start_api(orch)
    try:
        code, res = http(port, "POST", "/transfer", PIPELINE_TRANSFER)
        assert code == 200 and res["accepted"], res
        t0 = time.time()
        code, sealed = http(port, "POST", "/dev/seal", {})
        assert code == 200 and sealed["sealed"] is not None, sealed
        while True:
            _, stats = http(port, "GET", "/status/stats")
            if stats["batches_settled"] >= 1:
                break
            batch = orch.batches.sealed[0]
            assert batch.error is None, batch.error
            assert time.time() - t0 < timeout, "the batch did not settle"
            time.sleep(0.05)
        out = {"batch": orch.batches.sealed[0],
               "roots": http(port, "GET", "/status/roots")[1],
               "accounts": {h: http(port, "GET", f"/account/{h}")[1]
                            for h in (PIPELINE_TRANSFER["from"],
                                      PIPELINE_TRANSFER["to"])},
               "batch_record": http(port, "POST", "/batch",
                                    {"batch_id": sealed["sealed"]})[1]}
    finally:
        server.shutdown()
        service.stop()
    return out


def record_pipeline() -> None:
    from zelana_tpu.groth16.keys import ProvingKey
    from zelana_tpu.sequencer.account_tree import AccountState
    from zelana_tpu.sequencer.api import start_api
    from zelana_tpu.sequencer.batch import BatchConfig
    from zelana_tpu.sequencer.pipeline import (PipelineConfig,
                                               PipelineOrchestrator,
                                               PipelineService, ProverMode)
    from zelana_tpu.sequencer.prover_service import Groth16Prover
    from zelana_tpu.sequencer.settler import OnchainVerifyingSettler

    key = "artifacts/l2_dummy_pk.npz"
    pk = ProvingKey.load_npz(os.path.join(ROOT, key))
    prover = Groth16Prover(pk)
    settler = OnchainVerifyingSettler(pk.vk)
    seen = {}
    prove = prover.prove

    def keep(inputs, witness):
        seen["witness"] = witness
        return prove(inputs, witness)

    prover.prove = keep
    orch = PipelineOrchestrator(
        config=PipelineConfig(batch=BatchConfig(max_age_secs=3600),
                              prover_mode=ProverMode.GROTH16),
        prover=prover, settler=settler, dev_mode=True)
    served = serve_l2_batch(orch, start_api, PipelineService, AccountState)
    batch, witness = served["batch"], seen["witness"]
    assert prover.verify(batch.proof)
    inputs = batch.proof.public_inputs
    out = {
        "batch": "the L2 dummy batch served by the pipeline: 0x01.. funded "
                 "with 1000, POST /transfer 0x01.. -> 0x02.. 100 nonce 0, "
                 "POST /dev/seal",
        "key": key,
        "batch_id": batch.id,
        "transfer": PIPELINE_TRANSFER,
        "inputs": {k: v.hex() if isinstance(v, bytes) else v
                   for k, v in vars(inputs).items()},
        "transfers": [[t.signer_pubkey.hex(), t.to.hex(), t.amount, t.nonce]
                      for t in witness.transactions],
        "initial_accounts": [[a.hex(), bal] for a, bal
                             in witness.initial_accounts.items()],
        "shielded_commitments": [c.hex()
                                 for c in witness.shielded_commitments],
        "proof_bytes": batch.proof.proof_bytes.hex(),
        "submit_batch": settler.inner.submitted[0].hex(),
        "signature": batch.settlement_sig,
        "roots": served["roots"],
        "accounts": served["accounts"],
        "batch_record": served["batch_record"],
        "recorded_with": f"{CMD} pipeline (zelana_tpu.sequencer.pipeline."
                         "PipelineOrchestrator in GROTH16 mode with "
                         "Groth16Prover and OnchainVerifyingSettler, served "
                         "by zelana_tpu.sequencer.api.start_api)",
    }
    _write("pipeline_l2_proof.json", out)


def record_cli() -> None:
    import base64
    import contextlib
    import hashlib
    import io
    import tempfile

    from zelana_tpu import cli
    from zelana_tpu.groth16 import setup
    from zelana_tpu.sequencer import bridge_program as bp

    def sha(path):
        with open(path, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()

    def run(argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
        print(out.getvalue(), end="")
        return rc, out.getvalue().splitlines()

    with tempfile.TemporaryDirectory() as tmp:
        pk, vk = os.path.join(tmp, "proving.key"), os.path.join(tmp, "vk")
        _, lines = run(["keygen", "--seed", "0", "--pk-out", pk,
                        "--vk-out", vk])
        keygen = {"seed": 0, "pk_sha256": sha(pk), "vk_sha256": sha(vk),
                  "vk_hash_line": lines[-1]}

        proof = os.path.join(tmp, "l2_proof.json")
        _, lines = run(["prove", "--pk", pk, "--batch-id", "1",
                        "--out", proof])
        assert lines[-1].split(", ")[1] == "verified: True", lines
        with open(proof) as f:
            blob = base64.b64decode(json.load(f)["proof"]).hex()
        with open(os.path.join(TESTDATA, "l2_dummy_proof.json")) as f:
            assert blob == json.load(f)["proof"], "prove's proof is not " \
                "l2_dummy_proof.json's: record it here"

        desc = os.path.join(tmp, "deployment.json")
        run(["deploy", "--out", desc])
        with open(desc) as f:
            descriptor = f.read()

    seen = {"keys": [], "vk_accounts": [], "submits": []}
    keygen_fn, store_vk, process = (setup.keygen, bp.BridgeSVM.store_vk,
                                    bp.BridgeSVM.process)

    def keep_keygen(*a, **k):
        seen["keys"].append(keygen_fn(*a, **k))
        return seen["keys"][-1]

    def keep_vk(self, domain, vk_solana):
        seen["vk_accounts"].append(vk_solana)
        return store_vk(self, domain, vk_solana)

    def keep_submit(self, ix):
        if ix.program_id == bp.BRIDGE_PROGRAM_ID and ix.data[:1] == b"\x03":
            seen["submits"].append(ix.data)
        return process(self, ix)

    setup.keygen, bp.BridgeSVM.store_vk = keep_keygen, keep_vk
    bp.BridgeSVM.process = keep_submit
    try:
        rc, lines = run(["test", "--zk"])
    finally:
        setup.keygen, bp.BridgeSVM.store_vk = keygen_fn, store_vk
        bp.BridgeSVM.process = process
    assert rc == 0 and len(seen["submits"]) == 1, (rc, seen["submits"])
    (zk_pk,), (account,), (submit,) = (seen["keys"], seen["vk_accounts"],
                                       seen["submits"])
    out = {
        "keygen": keygen,
        "prove": {"batch_id": 1, "proof": "l2_dummy_proof.json"},
        "deploy": {"argv": ["deploy"], "descriptor": descriptor},
        "test_zk": {
            "batch_id": 1,
            "key_sha256": hashlib.sha256(
                zk_pk.serialize_compressed()).hexdigest(),
            "vk_account": {k: [p.hex() for p in v] if k == "ic" else v.hex()
                           for k, v in account.items()},
            "proof": submit[57:57 + 256].hex(),
            "submit_batch": submit.hex(),
            "lines": lines[:-2] + lines[-1:],
        },
        "recorded_with": f"{CMD} cli (zelana_tpu.cli.main: keygen --seed 0, "
                         "prove --pk <that file> --batch-id 1, deploy, "
                         "test --zk)",
    }
    _write("cli_vectors.json", out)


SHIELDED = {
    "spending_keys": [111, 222],
    "inputs": [{"value": 500, "randomness": 7, "owner": 0},
               {"value": 300, "randomness": 8, "owner": 0}],
    "outputs": [{"value": 490, "randomness": 21, "recipient": 1},
                {"value": 300, "randomness": 22, "recipient": 0}],
    "fee": 10,
    "batch_id": 1,
}


def _b32(v: int) -> bytes:
    return int(v).to_bytes(32, "little")


def shielded_instance(S, const: dict = SHIELDED, tamper=None):
    """The shielded transfer of `const`, built with the circuit module given
    (the JAX package's or the port's ``circuits.shielded``): every input
    note is inserted into a fresh ``NoteTree`` in order and spent by its
    Merkle path; keys, randomness and values are small integers, encoded
    as 32 bytes little-endian. `tamper(circuit)` edits it last."""
    sks = [_b32(k) for k in const["spending_keys"]]
    pks = [_b32(S.derive_owner_pk(sk)) for sk in sks]
    tree = S.NoteTree()
    notes = []
    for n in const["inputs"]:
        r, pk = _b32(n["randomness"]), pks[n["owner"]]
        cm = S.note_commitment(n["value"], r, pk)
        notes.append((n, r, pk, cm, tree.insert(cm)))
    inputs, nullifiers = [], []
    for n, r, pk, cm, pos in notes:
        sibs, bits = tree.path(pos)
        sk = sks[n["owner"]]
        inputs.append(S.InputNoteWitness(
            value=n["value"], randomness=r, owner_pk=pk, position=pos,
            spending_key=sk, merkle_path=sibs, path_bits=bits))
        nullifiers.append(_b32(S.note_nullifier(sk, cm, pos)))
    outputs = [S.OutputNoteWitness(value=o["value"],
                                   randomness=_b32(o["randomness"]),
                                   recipient_pk=pks[o["recipient"]])
               for o in const["outputs"]]
    circuit = S.ShieldedTransferCircuit(
        merkle_root=_b32(tree.root()), nullifiers=nullifiers,
        commitments=[_b32(S.note_commitment(o.value, o.randomness,
                                            o.recipient_pk))
                     for o in outputs],
        fee=const["fee"], inputs=inputs, outputs=outputs)
    if tamper:
        tamper(circuit)
    return circuit


def record_shielded() -> None:
    import hashlib
    import time

    from zelana_tpu.circuits import shielded as S
    from zelana_tpu.groth16.prove import prove, public_inputs_of
    from zelana_tpu.groth16.setup import keygen
    from zelana_tpu.groth16.verify import verify
    from zelana_tpu.r1cs.system import ConstraintSystem
    from zelana_tpu.sequencer.prover_service import proof_to_solana_bytes

    circuit = shielded_instance(S)
    cs = ConstraintSystem()
    circuit.generate_constraints(cs)
    assert cs.is_satisfied() is None
    t0 = time.time()
    pk = keygen(circuit, seed=0)
    t1 = time.time()
    proof = prove(pk, circuit, batch_id=SHIELDED["batch_id"])
    t2 = time.time()
    public = public_inputs_of(circuit)
    assert verify(pk.vk, proof, public)
    print(f"keygen {t1 - t0:.1f} s, prove {t2 - t1:.1f} s")
    out = {
        "circuit": "circuits/shielded.py ShieldedTransferCircuit, 2 inputs, "
                   "2 outputs, depth 32, built by shielded_instance()",
        "instance": SHIELDED,
        "num_instance": cs.num_instance, "num_witness": cs.num_witness,
        "num_constraints": cs.num_constraints,
        "public_inputs": [str(v) for v in public],
        "key_sha256": hashlib.sha256(pk.serialize_compressed()).hexdigest(),
        "vk": pk.vk.serialize_compressed().hex(),
        "proof": proof.serialize_compressed().hex(),
        "proof_bytes": proof_to_solana_bytes(proof).hex(),
        "recorded_with": f"{CMD} shielded (zelana_tpu.groth16.setup.keygen"
                         "(seed=0), then zelana_tpu.groth16.prove.prove as "
                         "batch 1)",
    }
    _write("shielded_proof.json", out)


def jac_msm_inputs(G1, G2, R) -> dict:
    """tests/test_msm.py:81-135's MSM inputs, from the curve modules given
    (the JAX package's or the port's): {name: (points, scalars)}."""
    import random

    rng = random.Random(99)
    g = G1.generator()
    points = [G1.mul(g, rng.randrange(1, R)) for _ in range(24)]
    scalars = [rng.randrange(R) for _ in range(24)]
    scalars[3] = 0
    points[5] = None
    points[10] = G1.neg(points[9])
    scalars[10] = scalars[9]
    rng1, rng2 = random.Random(98), random.Random(97)
    return {"g1_edges": (points, scalars),
            "g1_single": ([G1.generator()], [rng1.randrange(R)]),
            "g2_small": ([G2.mul(G2.generator(), rng2.randrange(1, 10**6))
                          for _ in range(4)],
                         [rng2.randrange(R) for _ in range(4)])}


def record_jac_msm() -> None:
    import numpy as np

    from zelana_tpu.curves import g1 as G1, g2 as G2
    from zelana_tpu.fields.bn254 import R
    from zelana_tpu.ops import msm as M

    out = {"recorded_with": f"{CMD} jac_msm (zelana_tpu.ops.msm._msm)"}
    for name, (points, scalars) in jac_msm_inputs(G1, G2, R).items():
        curve = name[:2]
        points, scalars = M._pad_pow2(points, scalars)
        to_device = (M.g1_points_to_device if curve == "g1"
                     else M.g2_points_to_device)
        coords, inf = to_device(points)
        jac = M._msm(coords, M.scalar_digits(scalars, inf), curve)
        leaves = jac if curve == "g1" else [c for pair in jac for c in pair]
        words = [np.asarray(x, np.uint32) for x in leaves]  # 16-bit limbs
        out[name] = [int(lo | hi << 16) for w in words
                     for lo, hi in zip(w[0::2, 0], w[1::2, 0])]
    _write("jac_msm_words.json", out)


def _write(name: str, obj: dict) -> None:
    with open(os.path.join(TESTDATA, name), "w") as f:
        json.dump(obj, f, indent=1)
        f.write("\n")
    print("wrote", name)


if __name__ == "__main__":
    which = sys.argv[1:] or ["l2", "ownership", "cubic", "cubic_many",
                             "pipeline", "cli", "shielded", "jac_msm"]
    if "l2" in which:
        record_l2()
    if "ownership" in which:
        record_ownership()
    if "cubic" in which:
        record_cubic()
    if "cubic_many" in which:
        record_cubic_many()
    if "pipeline" in which:
        record_pipeline()
    if "cli" in which:
        record_cli()
    if "shielded" in which:
        record_shielded()
    if "jac_msm" in which:
        record_jac_msm()
