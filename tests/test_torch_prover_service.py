"""The prover services of the port (zelana_tpu_torch.sequencer.prover_service,
runtime/ownership_api.py, circuits/ownership.py) against the JAX package's:
the batch's public inputs and witness on one seeded batch (host only), the
circuits the services prove, and the proofs of the recorded vectors
(zelana_tpu_torch/testdata/l2_batch_proof.json and ownership_proof.json,
made by tools/record_service_vectors.py with the JAX package). Equality is
exact.

The two CPU proofs (the L2 batch about 70 s, the ownership keygen and proof
about 70 s on one core) run with ZELANA_SLOW_TESTS=1; chip_smoke.py's
`services` phase proves both vectors on the card."""

import dataclasses
import json
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from zelana_tpu.circuits import ownership as JO
from zelana_tpu.groth16.keys import ProvingKey as JProvingKey
from zelana_tpu.r1cs.system import ConstraintSystem as JCS
from zelana_tpu.sequencer import prover_service as JSP
from zelana_tpu.sequencer import transactions as JTX
from zelana_tpu_torch.circuits import l2_block as TB
from zelana_tpu_torch.circuits import ownership as TO
from zelana_tpu_torch.groth16.keys import ProvingKey
from zelana_tpu_torch.r1cs.system import ConstraintSystem as TCS
from zelana_tpu_torch.runtime.ownership_api import OwnershipProver
from zelana_tpu_torch.sequencer import prover_service as SP
from zelana_tpu_torch.sequencer import transactions as TX

torch.set_num_threads(1)  # many small int64 ops: threads only contend

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTDATA = os.path.join(ROOT, "zelana_tpu_torch", "testdata")
L2_KEY = os.path.join(ROOT, "artifacts", "l2_dummy_pk.npz")
sys.path.insert(0, os.path.join(ROOT, "tools"))
from record_service_vectors import dummy_batch  # noqa: E402

slow = pytest.mark.skipif(
    not os.environ.get("ZELANA_SLOW_TESTS"),
    reason="a Groth16 proof on the CPU takes over a minute")


def _vector(name: str) -> dict:
    with open(os.path.join(TESTDATA, name)) as f:
        return json.load(f)


def _l2_batch(vec, sp, tx):
    """The recorded batch's (BatchPublicInputs, BatchWitness), built from
    the modules given (the port's or the JAX package's)."""
    inputs = sp.BatchPublicInputs(**{
        k: bytes.fromhex(v) if isinstance(v, str) else v
        for k, v in vec["inputs"].items()})
    witness = sp.BatchWitness(
        transactions=[tx.Transfer(bytes.fromhex(a), bytes.fromhex(b), amount,
                                  nonce)
                      for a, b, amount, nonce in vec["transfers"]],
        initial_accounts={bytes.fromhex(pk): balance
                          for pk, balance in vec["initial_accounts"]})
    return inputs, witness


def _seeded_batch(tx, rng):
    """Transfers, withdrawals and shielded notes of a seeded batch, as the
    transaction classes of `tx` (the port's or the JAX package's)."""
    pks = [rng.bytes(32) for _ in range(4)]
    txs = []
    for i in range(9):
        kind = i % 3
        if kind == 0:
            txs.append(tx.Transfer(pks[i % 4], pks[(i + 1) % 4],
                                   int(rng.integers(1, 1000)), i))
        elif kind == 1:
            txs.append(tx.Withdraw(pks[i % 4], rng.bytes(32),
                                   int(rng.integers(1, 1000)), i))
        else:
            txs.append(tx.Shielded(b"", rng.bytes(32), rng.bytes(32)))
    return SimpleNamespace(
        id=int(rng.integers(1, 1 << 32)), transactions=txs,
        pre_state_root=rng.bytes(32), post_state_root=rng.bytes(32),
        pre_shielded_root=rng.bytes(32), post_shielded_root=rng.bytes(32))


def _fields(obj):
    """A dataclass (or list of them) as comparable plain values."""
    if isinstance(obj, list):
        return [(type(o).__name__, _fields(o)) for o in obj]
    return dataclasses.asdict(obj) if dataclasses.is_dataclass(obj) else obj


def test_batch_inputs_and_witness_match_jax():
    """compute_batch_hash, build_public_inputs, build_witness,
    public_input_values and batch_inputs_to_solana_bytes on one seeded
    batch: the port (its own transaction classes) equals the JAX package."""
    ours = _seeded_batch(TX, np.random.default_rng(5))
    theirs = _seeded_batch(JTX, np.random.default_rng(5))
    balances = {pk: 100 + i for i, pk in enumerate(
        sorted({t.signer_pubkey for t in ours.transactions
                if isinstance(t, TX.Transfer)}
               | {t.to for t in ours.transactions
                  if isinstance(t, TX.Transfer)}
               | {t.from_ for t in ours.transactions
                  if isinstance(t, TX.Withdraw)}))}

    def account(pk):
        return SimpleNamespace(balance=balances[pk])

    assert SP.compute_batch_hash(ours.transactions) == JSP.compute_batch_hash(
        theirs.transactions)
    wd_root = bytes(range(32))
    got = SP.build_public_inputs(ours, wd_root)
    want = JSP.build_public_inputs(theirs, wd_root)
    assert _fields(got) == _fields(want)
    assert SP.public_input_values(got) == JSP.public_input_values(want)
    assert SP.batch_inputs_to_solana_bytes(got) == \
        JSP.batch_inputs_to_solana_bytes(want)
    gw, ww = SP.build_witness(ours, account), JSP.build_witness(theirs,
                                                                account)
    assert _fields(gw.transactions) == _fields(ww.transactions)
    assert gw.initial_accounts == ww.initial_accounts
    assert gw.shielded_commitments == ww.shielded_commitments
    assert len(gw.shielded_commitments) == 3


@pytest.fixture(scope="module")
def l2_key():
    return ProvingKey.load_npz(L2_KEY)


def test_groth16_prover_builds_the_jax_circuit(l2_key):
    """The recorded batch is the L2 dummy batch (the recorder's
    dummy_batch); Groth16Prover.build_circuit of it equals the JAX
    prover's circuit, and its public inputs are the vector's."""
    vec = _vector("l2_batch_proof.json")
    prover = SP.Groth16Prover(l2_key, device="cpu")
    inputs, witness = _l2_batch(vec, SP, TX)
    j_inputs, j_witness = _l2_batch(vec, JSP, JTX)
    d_inputs, d_witness = dummy_batch(TB, SP, TX, vec["batch_id"])
    assert _fields(inputs) == _fields(d_inputs)
    assert _fields(witness.transactions) == _fields(d_witness.transactions)
    assert witness.initial_accounts == d_witness.initial_accounts
    got = prover.build_circuit(inputs, witness)
    want = JSP.Groth16Prover(JProvingKey.load_npz(L2_KEY)).build_circuit(
        j_inputs, j_witness)
    assert _fields(got) == _fields(want)
    assert [str(v) for v in SP.public_input_values(inputs)] == vec[
        "public_inputs"]
    assert prover.verification_key_hash() == JSP.Groth16Prover(
        JProvingKey.load_npz(L2_KEY)).verification_key_hash()


@slow
def test_groth16_prover_matches_vector(l2_key):
    """Groth16Prover(device="cpu").prove of the L2 dummy batch, batch 1:
    the 256 bytes of the JAX Groth16Prover's proof, and it verifies."""
    vec = _vector("l2_batch_proof.json")
    prover = SP.Groth16Prover(l2_key, device="cpu")
    proof = prover.prove(*_l2_batch(vec, SP, TX))
    assert proof.proof_bytes.hex() == vec["proof_bytes"]
    assert prover.verify(proof)


def _synthesized(circuit, CS):
    cs = CS()
    circuit.generate_constraints(cs)
    return cs.matrices(), cs.full_assignment(), cs.num_instance


def test_ownership_circuit_matches_jax():
    """The port's copy of OwnershipCircuit synthesizes the JAX copy's
    matrices and assignment for the recorded witness and for keygen's."""
    vec = _vector("ownership_proof.json")
    for witness in (vec["witness"], [1, 1, 1, 0]):
        got = _synthesized(TO.OwnershipCircuit.from_witness(*witness), TCS)
        want = _synthesized(JO.OwnershipCircuit.from_witness(*witness), JCS)
        assert got == want
    circuit = TO.OwnershipCircuit.from_witness(*vec["witness"])
    assert [str(v) for v in (circuit.commitment, circuit.nullifier,
                             circuit.blinded_proxy)] == vec["public_inputs"]


@slow
def test_ownership_prover_matches_vector():
    """OwnershipProver(device="cpu"): seed-0 keygen, then the proof of the
    recorded witness, byte-equal to the JAX OwnershipProver's; it
    verifies, and a wrong expected commitment is refused."""
    vec = _vector("ownership_proof.json")
    prover = OwnershipProver(device="cpu")
    res = prover.prove(*vec["witness"])
    for key in ("proof", "public_inputs", "public_witness"):
        assert res[key] == vec[key]
    assert prover.verify(bytes.fromhex(res["proof"]),
                         [int(v) for v in res["public_inputs"]])
    with pytest.raises(ValueError, match="commitment mismatch"):
        prover.prove(*vec["witness"], expected_commitment=1)


def test_build_prover_from_config_raises(tmp_path):
    """The port's prover selection builds Groth16 or raises: no mock for a
    mock or Noir configuration, a missing key file or a missing key."""
    from zelana_tpu.groth16.setup import keygen

    class Cubic:
        def generate_constraints(self, cs):
            out = cs.new_input(35)
            x = cs.new_witness(3)
            ((x * x) * x + x + cs.constant(5)).enforce_equal(out)

    key = tmp_path / "cubic.pk"
    key.write_bytes(keygen(Cubic(), seed=0).serialize_compressed())

    def cfg(**kw):
        base = dict(prover_mode="groth16", mock_prover=False,
                    proving_key=str(key))
        return SimpleNamespace(**{**base, **kw})

    prover = SP.build_prover_from_config(cfg(), device="cpu")
    assert isinstance(prover, SP.Groth16Prover)
    assert prover.pk.serialize_compressed() == key.read_bytes()
    for bad in (cfg(prover_mode="mock"), cfg(prover_mode="noir"),
                cfg(mock_prover=True), cfg(proving_key="")):
        with pytest.raises(ValueError):
            SP.build_prover_from_config(bad, device="cpu")
    with pytest.raises(OSError):
        SP.build_prover_from_config(
            cfg(proving_key=str(tmp_path / "missing.pk")), device="cpu")
