"""Groth16 proofs of the port (zelana_tpu_torch.groth16.prove, device="cpu",
the kernels' plain versions) against the JAX package's on the CPU: the same
key (JAX keygen, carried over with proving_key_from_arrays), circuit and
batch ids give byte-equal proofs."""

import json
import os

import numpy as np
import pytest
import torch

from zelana_tpu.groth16 import prove as JP
from zelana_tpu.groth16.setup import keygen
from zelana_tpu_torch.groth16 import prove as TP
from zelana_tpu_torch.groth16.keys import ProvingKey, proving_key_from_arrays
from zelana_tpu_torch.groth16.verify import verify

torch.set_num_threads(1)  # many small int64 ops: threads only contend

TESTDATA = os.path.join(os.path.dirname(__file__), "..", "zelana_tpu_torch",
                        "testdata", "l2_dummy_proof.json")


class CubicCircuit:
    """x^3 + x + 5 == out (tests/test_groth16.py)."""

    def __init__(self, x, out):
        self.x, self.out = x, out

    def generate_constraints(self, cs):
        out = cs.new_input(self.out)
        x = cs.new_witness(self.x)
        x3 = (x * x) * x
        (x3 + x + cs.constant(5)).enforce_equal(out)


def _cubic(x):
    return CubicCircuit(x, x**3 + x + 5)


@pytest.fixture(scope="module")
def keys(tmp_path_factory):
    pk_jax = keygen(_cubic(3), seed=0)
    path = tmp_path_factory.mktemp("keys") / "cubic_pk.npz"
    pk_jax.save_npz(str(path))
    with np.load(path) as arrays:
        pk = proving_key_from_arrays(arrays)
    return pk_jax, pk


def test_key_carried_over(keys):
    pk_jax, pk = keys
    assert pk.serialize_compressed() == pk_jax.serialize_compressed()


def test_prove_matches_jax(keys):
    pk_jax, pk = keys
    want = JP.prove(pk_jax, _cubic(3), batch_id=7)
    got = TP.prove(pk, _cubic(3), batch_id=7, device="cpu")
    assert got.serialize_compressed() == want.serialize_compressed()
    assert verify(pk.vk, got, [35])
    assert not verify(pk.vk, got, [36])


def test_prove_many_matches_jax(keys):
    pk_jax, pk = keys
    jobs = [(_cubic(5), 11), (_cubic(5), 12)]
    want = JP.prove_many(pk_jax, jobs)
    got = TP.prove_many(pk, jobs, device="cpu")
    assert [p.serialize_compressed() for p in got] == [
        p.serialize_compressed() for p in want]
    assert got[0].a != got[1].a
    assert all(verify(pk.vk, p, [135]) for p in got)


def test_unsatisfied_witness_rejected(keys):
    _pk_jax, pk = keys
    with pytest.raises(ValueError):
        TP.prove(pk, CubicCircuit(3, 36), batch_id=0, device="cpu")


def _l2_circuit(mod):
    c = mod.L2BlockCircuit.dummy()
    final = mod.apply_transfers(c.initial_accounts, c.transactions)
    c.pre_state_root = mod.compute_state_root(c.batch_id, c.initial_accounts)
    c.post_state_root = mod.compute_state_root(c.batch_id, final)
    c.withdrawal_root = mod.compute_withdrawal_root(c.withdrawals)
    c.batch_hash = mod.compute_batch_hash(c.batch_id, c.transactions)
    return c


@pytest.mark.skipif(
    not os.environ.get("ZELANA_SLOW_TESTS"),
    reason="two L2 proofs on the CPU take minutes")
def test_l2_dummy_vector_rederived():
    """testdata/l2_dummy_proof.json is the JAX package's batch_id 1 proof of
    the L2 dummy circuit with artifacts/l2_dummy_pk.npz; the port gives the
    same bytes."""
    from zelana_tpu.circuits import l2_block as JB
    from zelana_tpu.groth16.keys import ProvingKey as JProvingKey
    from zelana_tpu_torch.circuits import l2_block as TB

    with open(TESTDATA) as f:
        vec = json.load(f)
    key = os.path.join(os.path.dirname(__file__), "..", "artifacts",
                       "l2_dummy_pk.npz")
    want = JP.prove(JProvingKey.load_npz(key), _l2_circuit(JB),
                    batch_id=vec["batch_id"])
    assert want.serialize_compressed().hex() == vec["proof"]
    circuit = _l2_circuit(TB)
    assert [str(x) for x in TP.public_inputs_of(circuit)] == vec[
        "public_inputs"]
    got = TP.prove(ProvingKey.load_npz(key), circuit,
                   batch_id=vec["batch_id"], device="cpu")
    assert got.serialize_compressed().hex() == vec["proof"]
