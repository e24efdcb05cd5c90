"""The port's chunk path on the CPU against the JAX package: native
synthesis and its helpers, keygen, the native witness map and the host
pieces of the chunk prover (wire formats, chunk building, root chaining).
Equality is exact throughout.

The slow test (ZELANA_SLOW_TESTS=1) re-derives
zelana_tpu_torch/testdata/chunk_101_d1_proof.json with the JAX package and
proves the same chunk, and a second one through the pipelined
prove_chunks, with the port on the CPU."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from zelana_tpu.groth16 import prove as JP
from zelana_tpu.groth16 import setup as JS
from zelana_tpu.poly.domain import Domain as JDomain
from zelana_tpu.r1cs import native_synth as JN
from zelana_tpu.runtime import chunk_prover as JCP
from zelana_tpu.runtime import chunk_witness as JCW
from zelana_tpu.runtime import coordinator as JCO
from zelana_tpu.circuits import batch_mimc as JBM
from zelana_tpu_torch.circuits import batch_mimc as TBM
from zelana_tpu_torch.groth16 import prove as TP
from zelana_tpu_torch.groth16 import setup as TS
from zelana_tpu_torch.groth16.keys import ProvingKey
from zelana_tpu_torch.poly.domain import Domain as TDomain
from zelana_tpu_torch.r1cs import native_synth as TN
from zelana_tpu_torch.runtime import chunk_prover as TCP
from zelana_tpu_torch.runtime import chunk_witness as TCW
from zelana_tpu_torch.runtime import coordinator as TCO

torch.set_num_threads(1)  # many small int64 ops: threads only contend

ROOT = os.path.join(os.path.dirname(__file__), "..")
VECTOR = os.path.join(ROOT, "zelana_tpu_torch", "testdata",
                      "chunk_101_d1_proof.json")
KEY_101 = os.path.join(ROOT, "artifacts", "chunk_101_d1_pk.npz")


def _chunk_001_d2(BM, CW):
    """The (0,0,1) depth-2 empty chunk (9,483 constraints), satisfiable."""
    c = BM.BatchCircuitMiMC(max_transfers=0, max_withdrawals=0,
                            max_shielded=1, tree_depth=2, num_shielded=0)
    c.withdrawal_root, c.batch_hash = CW.chunk_accumulators(0, [], [], [])
    return c


@pytest.fixture(scope="module")
def systems():
    return (JN.synthesize_chunk(_chunk_001_d2(JBM, JCW)),
            TN.synthesize_chunk(_chunk_001_d2(TBM, TCW)))


def test_native_synth_matches_jax(systems):
    js, ts = systems
    assert ts.num_constraints == js.num_constraints == 9483
    assert ts.num_instance == js.num_instance
    assert np.array_equal(ts.z, js.z)
    assert ts.check() == js.check() == -1
    for which in "ABC":
        for mont in (False, True):
            assert np.array_equal(ts.matvec(which, mont),
                                  js.matvec(which, mont))
    mont = ts.matvec("A", mont=True)
    assert np.array_equal(TN.limbs16(mont), JN.limbs16(mont))
    assert np.array_equal(TN.from_mont_limbs16(TN.limbs16(mont)),
                          JN.from_mont_limbs16(JN.limbs16(mont)))
    assert np.array_equal(TN.from_mont_words(TN.words32(mont)),
                          ts.matvec("A"))
    dom = TDomain.new(ts.num_constraints + ts.num_instance)
    t = 0xDEADBEEFCAFE
    u, zt = TN.lagrange_at(dom.group_gen, dom.size_inv, t, dom.size)
    ju, jzt = JN.lagrange_at(dom.group_gen, dom.size_inv, t, dom.size)
    assert np.array_equal(u, ju) and zt == jzt
    for which in "ABC":
        assert np.array_equal(ts.qap_accumulate(which, u),
                              js.qap_accumulate(which, ju))
    assert np.array_equal(TN.powers_scaled(t, 77, 300),
                          JN.powers_scaled(t, 77, 300))
    a, b, c = (ts.qap_accumulate(w, u)[:64] for w in "ABC")
    assert np.array_equal(TN.abc_combine(a, b, c, 5, 7, 11),
                          JN.abc_combine(a, b, c, 5, 7, 11))
    got = TS._qap_at_native(ts, t, dom)
    want = JS._qap_at_native(
        js, t, JDomain.new(js.num_constraints + js.num_instance))
    for g, w in zip(got[:3], want[:3]):
        assert np.array_equal(g, w)
    assert got[3] == want[3]
    bad = TN.synthesize_chunk(_chunk_001_d2(TBM, TCW))
    bad.z[bad.num_instance + 3, 0] += 1
    assert bad.check() != -1


def test_native_encoder_matches_python():
    from zelana_tpu_torch.ops import limbs as L

    rng = np.random.default_rng(5)
    for spec in (L.FQ, L.FR):
        vals = [int.from_bytes(rng.bytes(32), "little") >> 2
                for _ in range(L.NATIVE_MIN)]
        vals[:4] = [0, spec.modulus - 1, spec.modulus, (1 << 256) - 1]
        want = L.to_words([(v * L.MONT_R) % spec.modulus for v in vals])
        assert np.array_equal(L.encode_mont(vals, spec), want)


class _Cubic:
    """x^3 + x + 5 == out: keygen stays on the host-table branch."""

    def generate_constraints(self, cs):
        out = cs.new_input(35)
        x = cs.new_witness(3)
        ((x * x) * x + x + cs.constant(5)).enforce_equal(out)


def test_keygen_host_branch_matches_jax(tmp_path):
    JS.keygen(_Cubic(), seed=0).save_npz(str(tmp_path / "jax.npz"))
    TS.keygen(_Cubic(), seed=0, device="cpu").save_npz(
        str(tmp_path / "port.npz"))
    with np.load(tmp_path / "jax.npz") as want, \
            np.load(tmp_path / "port.npz") as got:
        assert sorted(got.files) == sorted(want.files)
        for name in want.files:
            assert np.array_equal(got[name], want[name]), name


def test_witness_map_native_matches_jax(systems):
    js, ts = systems
    want, m = JP.witness_map_dispatch_native(js)
    got, size = TP.witness_map_dispatch_native(ts, device="cpu")
    from zelana_tpu_torch.ops import limbs as L

    assert size == m
    assert np.array_equal(L.to_numpy(got), np.asarray(want))
    staged = TP.witness_map_stage_native(ts, "cpu")
    wrong = TP.StagedWitnessMap(staged.words, 2 * staged.size)
    with pytest.raises(AssertionError, match="domain"):
        TP.witness_map_dispatch_native(ts, wrong, device="cpu")


def _build(CW, CO, depth=4):
    b = CW.ChunkWitnessBuilder(depth)
    for pk in range(1, 6):
        b.fund(pk, 1_000)
    note = b.add_note(spending_key=4242, value=9, blinding=31337)
    chunks = CO.Dispatcher.build_chunks_with_witness(
        b, [(1, 2, 25), (3, 4, 10), (2, 5, 7)], [(2, 0xBEEF, 7)],
        [("full", note, 4242, 0xFACE, 9, 77), 555, 556],
        capacity=(2, 1, 2), pre_shielded_root=b.shielded_root())
    return b, chunks


def test_chunk_host_pieces_match_jax():
    (_, jchunks), (_, tchunks) = _build(JCW, JCO), _build(TCW, TCO)
    assert len(tchunks) == 2
    assert [dataclasses.asdict(c) for c in tchunks] == [
        dataclasses.asdict(c) for c in jchunks]
    assert tchunks[0].post_state_root == tchunks[1].pre_state_root

    def apply(chunk, state, shielded):
        return (state * 3 + chunk.index + 1) % (1 << 64), shielded + 2

    for c in tchunks + jchunks:
        c.pre_state_root = c.post_state_root = 0
    assert TCO.Dispatcher.chain_roots(tchunks, 7, 9, apply) == \
        JCO.Dispatcher.chain_roots(jchunks, 7, 9, apply)
    assert [dataclasses.asdict(c) for c in tchunks] == [
        dataclasses.asdict(c) for c in jchunks]

    values = list(range(1, 8))
    pw = TCP.sunspot_public_witness(values)
    assert pw == JCP.sunspot_public_witness(values)
    assert TCP.parse_public_witness(pw) == values
    assert TCP.parse_public_witness(pw[:40]) == JCP.parse_public_witness(
        pw[:40])


def test_dryrun_vector_verifies():
    """The recorded JAX proof decodes through the sunspot format and
    verifies under the committed key with the port's verifier; so does not
    a proof against other public inputs."""
    from zelana_tpu.groth16.keys import Proof as JProof

    with open(VECTOR) as f:
        vec = json.load(f)
    pk = ProvingKey.load_npz(KEY_101)
    prover = TCP.Groth16ChunkProver(pk, (1, 0, 1), 1, device="cpu")
    proof_bytes = bytes.fromhex(vec["proof_bytes"])
    values = [int(v) for v in vec["public_inputs"]]
    cp = TCO.ChunkProof(0, proof_bytes, values, 0,
                        bytes.fromhex(vec["public_witness"]))
    assert prover.verify_chunk(cp)
    assert TCP.parse_public_witness(cp.public_witness) == values
    assert not prover.verify_chunk(dataclasses.replace(
        cp, public_inputs=values[:6] + [values[6] + 1]))
    from zelana_tpu.sequencer.prover_service import (
        proof_to_solana_bytes as jbytes)
    from zelana_tpu_torch.sequencer.prover_service import (
        proof_to_solana_bytes, solana_bytes_to_proof)

    proof = solana_bytes_to_proof(proof_bytes[:256])
    assert proof_to_solana_bytes(proof) == proof_bytes[:256]
    assert jbytes(JProof(proof.a, proof.b, proof.c)) == proof_bytes[:256]
    assert TCP.sunspot_proof_bytes(proof) == proof_bytes


def _dryrun_chunks(CW, CO, two: bool):
    b = CW.ChunkWitnessBuilder(1)
    b.fund(1, 100)  # depth-1 SMT: positions pk & 1
    b.fund(2, 0)
    note = b.add_note(spending_key=777, value=9, blinding=42)
    return CO.Dispatcher.build_chunks_with_witness(
        b, [(1, 2, 10)] + ([(2, 1, 5)] if two else []), [],
        [("full", note, 777, 0xFACE, 9, 7)] + ([777] if two else []),
        capacity=(1, 0, 1), pre_shielded_root=b.shielded_root())


@pytest.mark.skipif(
    not os.environ.get("ZELANA_SLOW_TESTS"),
    reason="a JAX chunk prove (~6 min) and two port proves on the CPU")
def test_dryrun_chunk_vector_rederived():
    from zelana_tpu.groth16.keys import ProvingKey as JProvingKey

    with open(VECTOR) as f:
        vec = json.load(f)
    jprover = JCP.Groth16ChunkProver(JProvingKey.load_npz(KEY_101),
                                     (1, 0, 1), 1)
    want = jprover.prove_chunk(_dryrun_chunks(JCW, JCO, False)[0],
                               vec["batch_id"])
    assert want.proof_bytes.hex() == vec["proof_bytes"]
    assert [str(v) for v in want.public_inputs] == vec["public_inputs"]

    prover = TCP.Groth16ChunkProver(ProvingKey.load_npz(KEY_101), (1, 0, 1),
                                    1, device="cpu")
    chunks = _dryrun_chunks(TCW, TCO, True)
    got = prover.prove_chunks(chunks, vec["batch_id"])
    assert got[0].proof_bytes.hex() == vec["proof_bytes"]
    assert all(prover.verify_chunk(cp) for cp in got)
    assert got[0].public_inputs[1] == got[1].public_inputs[0]
