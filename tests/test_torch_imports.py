"""The port stands alone: it imports neither JAX nor the JAX package, and its
entry points run on the card unless the caller asks for the CPU."""

import os
import re
import subprocess
import sys

import pytest
import torch

import zelana_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(zelana_tpu_torch.__file__)

_PROVE = r"""
import sys
sys.path.insert(0, {root!r})
import zelana_tpu_torch
from zelana_tpu_torch.groth16.keys import ProvingKey
from zelana_tpu_torch.groth16.prove import prove
from zelana_tpu_torch.groth16.verify import verify
from zelana_tpu_torch.r1cs.system import ConstraintSystem


class Cubic:
    def generate_constraints(self, cs):
        out = cs.new_input(35)
        x = cs.new_witness(3)
        ((x * x) * x + x + cs.constant(5)).enforce_equal(out)


pk = ProvingKey.load_npz({key!r})
assert verify(pk.vk, prove(pk, Cubic(), batch_id=3, device="cpu"), [35])

# the chunk path's modules: keygen, native synthesis, the chunk prover
from zelana_tpu_torch.groth16.setup import keygen
from zelana_tpu_torch.ops import fixed_base, staging
from zelana_tpu_torch.runtime.chunk_prover import Groth16ChunkProver
from zelana_tpu_torch.runtime.chunk_witness import ChunkWitnessBuilder
from zelana_tpu_torch.runtime.coordinator import Dispatcher

assert (keygen(Cubic(), seed=0, device="cpu").serialize_compressed()
        == pk.serialize_compressed())
system = __import__("zelana_tpu_torch.r1cs.native_synth", fromlist=["x"]
                    ).synthesize_chunk(Groth16ChunkProver.dummy_circuit(
                        (0, 0, 0), 1))
assert system.check() == -1

# the MSMs over the tape and Jacobian kernels, the prover services
from zelana_tpu_torch.circuits import ownership
from zelana_tpu_torch.ops import curve_ops, msm, msm_fast, tape_native
from zelana_tpu_torch.runtime import ownership_api
from zelana_tpu_torch.sequencer import prover_service, transactions

from zelana_tpu_torch.curves import g1

assert msm_fast.msm_g1([(1, 2)], [5], device="cpu") == g1.mul((1, 2), 5)

# the multi-card path
from zelana_tpu_torch.parallel import comm, distributed, sharded

assert distributed.init_distributed(device="cpu") is False

# the command line and the L1 side, swarm and client SDK it drives
from zelana_tpu_torch import cli
from zelana_tpu_torch.groth16 import solana_vk
from zelana_tpu_torch.runtime import control, prover_node
from zelana_tpu_torch.sdk import client, keypair, mpc, zephyr
from zelana_tpu_torch.sequencer import bridge_program, settler, ws
from zelana_tpu_torch.tools import bench_udp, e2e, explorer

assert cli.main(["test"]) == 0 and e2e.main() == 0
assert settler.BridgeProgramSettler

# the shielded transfer circuit and the last host modules
from zelana_tpu_torch.circuits import shielded
from zelana_tpu_torch.sdk import block, privacy, txblob
from zelana_tpu_torch.sdk import ownership as sdk_ownership
from zelana_tpu_torch.tools import db_tui, inspect_db

assert shielded.NoteTree().root() == shielded.NoteTree()._empty[32]
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or (m.startswith("zelana_tpu") and
                 not m.startswith("zelana_tpu_torch")))
print("FOREIGN", bad)
"""


@pytest.fixture(scope="module")
def cubic_key(tmp_path_factory):
    from zelana_tpu.groth16.setup import keygen

    class Cubic:
        def generate_constraints(self, cs):
            out = cs.new_input(35)
            x = cs.new_witness(3)
            ((x * x) * x + x + cs.constant(5)).enforce_equal(out)

    path = tmp_path_factory.mktemp("keys") / "cubic_pk.npz"
    keygen(Cubic(), seed=0).save_npz(str(path))
    return str(path)


def test_cpu_prove_loads_no_jax(cubic_key):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-c", _PROVE.format(root=ROOT, key=cubic_key)],
        capture_output=True, text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOREIGN []" in out.stdout


def test_sources_import_no_jax():
    """No import of JAX or of the JAX package, and no string naming a
    module of the JAX package (`"zelana_tpu.cli"` as a `-m` argument, an
    `__import__` name): a subprocess or a dynamic import would load it."""
    pattern = re.compile(r"^\s*(import|from)\s+(jax|zelana_tpu)(\.|\s|$)",
                         re.M)
    named = re.compile(r"[\"']zelana_tpu\.\w")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PKG):
        files += [os.path.join(d, f) for f in names if f.endswith(".py")]
    hits = []
    for f in files:
        with open(f) as fh:
            text = fh.read()
        hits += [f"{f}: {m.group(0).strip()}"
                 for m in pattern.finditer(text)]
        hits += [f"{f}: {text[m.start():m.start() + 40]}"
                 for m in named.finditer(text)]
    assert len(files) > 20 and hits == []
    assert named.search('["-m", "zelana_tpu.cli", "node"]')
    assert not named.search('["-m", "zelana_tpu_torch.cli", "node"]')


def test_default_device_raises_without_cuda(cubic_key, tmp_path,
                                            monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from zelana_tpu_torch.groth16.keys import ProvingKey, prepare_queries
    from zelana_tpu_torch.groth16.prove import prove, prove_many
    from zelana_tpu_torch.ops import msm_scan

    pk = ProvingKey.load_npz(cubic_key)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prove(pk, object())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prove_many(pk, [(object(), 0)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prepare_queries(pk)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        msm_scan.msm_g1([(1, 2)], [5])

    from zelana_tpu_torch.curves import g1, g2
    from zelana_tpu_torch.groth16.prove import prove_synthesized
    from zelana_tpu_torch.groth16.setup import keygen, keygen_synthesized
    from zelana_tpu_torch.ops import fixed_base
    from zelana_tpu_torch.runtime.chunk_prover import Groth16ChunkProver

    from zelana_tpu_torch.hashes import mimc_batch, poseidon_batch
    from zelana_tpu_torch.hashes.poseidon import bn254_config
    from zelana_tpu_torch.ops import msm, msm_fast
    from zelana_tpu_torch.runtime.ownership_api import OwnershipProver
    from zelana_tpu_torch.sequencer.prover_service import Groth16Prover

    from zelana_tpu_torch import cli
    from zelana_tpu_torch.runtime.control import SwarmController
    from zelana_tpu_torch.tools import bench_udp

    key = tmp_path / "cubic.key"
    key.write_bytes(pk.serialize_compressed())
    monkeypatch.setenv("ZL_PROVER_MODE", "groth16")
    monkeypatch.setenv("ZL_MOCK_PROVER", "0")
    monkeypatch.setenv("ZL_PROVING_KEY", str(key))
    monkeypatch.chdir(tmp_path)
    out = str(tmp_path / "out")
    for argv in (["keygen", "--pk-out", out, "--vk-out", out],
                 ["prove", "--pk", str(key), "--out", out],
                 ["worker", "--capacity", "0/0/0", "--depth", "1"],
                 ["dev", "--ephemeral"],
                 ["test", "--zk"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(argv)
    assert not os.path.exists(out)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_udp.main(["--count", "1"])
    worker = SwarmController(log_dir=str(tmp_path / "swarm"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        worker.start_worker("w", capacity="0/0/0", depth=1, timeout=120)
    assert worker.status() == {}

    for call in (lambda: keygen(object()),
                 lambda: keygen_synthesized(object()),
                 lambda: prove_synthesized(pk, object()),
                 lambda: fixed_base.prepare_table_g1(g1.generator()),
                 lambda: Groth16ChunkProver(pk, (1, 0, 1), 1),
                 lambda: Groth16ChunkProver.setup((0, 0, 0), 1),
                 lambda: mimc_batch.hash2_many([(1, 2)]),
                 lambda: poseidon_batch.hash_many(bn254_config(), [(1, 2)]),
                 lambda: msm.msm_g2([g2.generator()], [5]),
                 lambda: msm_fast.msm_g1([(1, 2)], [5]),
                 lambda: Groth16Prover(pk),
                 lambda: OwnershipProver()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_mesh_entry_points_raise_without_cuda(cubic_key, tmp_path):
    """With no card, the multi-card entry points raise unless given
    device="cpu": the process groups, run_local, and prove / the chunk
    prover with a mesh."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from zelana_tpu_torch.groth16.keys import ProvingKey
    from zelana_tpu_torch.groth16.prove import (prove, prove_many,
                                                prove_synthesized)
    from zelana_tpu_torch.parallel import distributed as D
    from zelana_tpu_torch.parallel import sharded
    from zelana_tpu_torch.runtime.chunk_prover import Groth16ChunkProver

    pk = ProvingKey.load_npz(cubic_key)
    mesh = D.Mesh(group=None, size=2, rank=0, device=torch.device("cpu"),
                  backend="gloo")
    for call in (lambda: D.init_distributed(),
                 lambda: D.init_file_store(str(tmp_path / "store"), 1, 0),
                 lambda: D.global_mesh(),
                 lambda: sharded.make_mesh(),
                 lambda: D.run_local(print, 2),
                 lambda: prove(pk, object(), mesh=mesh),
                 lambda: prove_many(pk, [(object(), 0)], mesh=mesh),
                 lambda: prove_synthesized(pk, object(), mesh=mesh),
                 lambda: Groth16ChunkProver(pk, (1, 0, 1), 1, mesh=mesh)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert D.init_distributed(device="cpu") is False
