"""Several proves at once in one process (device="cpu", the kernels' plain
versions), as the JAX package's worker and API run them: the port's
process-wide state is built once and counted exactly under concurrent
first calls, and concurrent proofs are byte-equal to the JAX package's.

- Three `prove` calls and one `prove_many` of the cubic circuit on four
  threads, held to the JAX proofs of the same key and batch ids
  (testdata/cubic_many_proofs.json, recorded by
  `JAX_PLATFORMS=cpu python tools/record_service_vectors.py cubic_many`).
- `ops/ntt.make_plan` at a fresh size from 8 threads: one build.
- `groth16/keys.prepare_queries` from 4 threads: one build of each pool.
- `ops/cuda.count` from 8 threads: exact.
- `sequencer/native.load` from 8 threads: one bind and one warming hash
  (csrc/mimc.cpp fills its round constants at its first hash behind a
  plain flag); then `hash2_be` from 8 threads equal to the JAX package's
  host MiMC.
- `trace`: two threads' spans recorded at once, each tagged with its
  thread and request, and handed to worker threads with their parent.

Each patched build function sleeps a little, so that threads which ask
first all reach it while the first build runs."""

import concurrent.futures as cf
import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from zelana_tpu.groth16.setup import keygen
from zelana_tpu.hashes import mimc as JMIMC
from zelana_tpu_torch import native as TN
from zelana_tpu_torch import trace as TT
from zelana_tpu_torch.groth16 import prove as TP
from zelana_tpu_torch.groth16.keys import prepare_queries, \
    proving_key_from_arrays
from zelana_tpu_torch.groth16.verify import verify
from zelana_tpu_torch.ops import cuda
from zelana_tpu_torch.ops import msm_scan as MSM
from zelana_tpu_torch.ops import ntt as NTT
from zelana_tpu_torch.sequencer import native as seq_native

from test_torch_prove import _cubic

torch.set_num_threads(1)

VECTORS = os.path.join(os.path.dirname(__file__), "..", "zelana_tpu_torch",
                       "testdata", "cubic_many_proofs.json")
SLOW_BUILD_S = 0.05


def at_once(fns) -> list:
    """Run each of `fns` on its own thread, all released together; their
    results in order. An exception on any thread is raised here, and so is
    a thread still running after ten minutes."""
    barrier = threading.Barrier(len(fns))

    def run(fn):
        barrier.wait()
        return fn()

    with cf.ThreadPoolExecutor(len(fns)) as ex:
        futures = [ex.submit(run, fn) for fn in fns]
        return [f.result(timeout=600) for f in futures]


def counted(calls: list, fn):
    """`fn` that appends to `calls` and then sleeps before it runs."""

    def wrapper(*args, **kwargs):
        calls.append(args)
        time.sleep(SLOW_BUILD_S)
        return fn(*args, **kwargs)

    return wrapper


@pytest.fixture(scope="module")
def cubic_key(tmp_path_factory):
    """The JAX package's seed-0 key of the cubic circuit, carried over."""
    path = tmp_path_factory.mktemp("keys") / "cubic_pk.npz"
    keygen(_cubic(3), seed=0).save_npz(str(path))
    return str(path)


def fresh_key(path: str):
    """The carried-over key with no query pools prepared yet."""
    with np.load(path) as arrays:
        return proving_key_from_arrays(arrays)


def test_proves_on_four_threads_match_jax(cubic_key):
    with open(VECTORS) as f:
        vec = json.load(f)
    pk = fresh_key(cubic_key)
    x, ids = vec["prove"]["x"], vec["prove"]["batch_ids"]
    mx, mids = vec["prove_many"]["x"], vec["prove_many"]["batch_ids"]
    single = [lambda b=b: TP.prove(pk, _cubic(x), batch_id=b, device="cpu")
              for b in ids]
    many = lambda: TP.prove_many(pk, [(_cubic(mx), b) for b in mids],
                                 device="cpu")
    *got, got_many = at_once(single + [many])
    assert [p.serialize_compressed().hex() for p in got] == (
        vec["prove"]["proofs"])
    assert [p.serialize_compressed().hex() for p in got_many] == (
        vec["prove_many"]["proofs"])
    assert all(verify(pk.vk, p, [x ** 3 + x + 5]) for p in got)
    assert all(verify(pk.vk, p, [mx ** 3 + mx + 5]) for p in got_many)


def test_make_plan_builds_once(monkeypatch):
    NTT._build_plan.cache_clear()
    calls = []
    monkeypatch.setattr(NTT, "_powers_mont", counted(calls, NTT._powers_mont))
    plans = at_once([lambda: NTT.make_plan(1 << 10)] * 8)
    assert len(calls) == 4  # twiddles, their inverses, g^j, 1/n g^-j
    assert all(p is plans[0] for p in plans) and plans[0].n == 1 << 10
    tables = at_once([lambda: plans[0].on(torch.device("cpu"))] * 8)
    assert all(t is tables[0] for t in tables)


def test_prepare_queries_builds_once(cubic_key, monkeypatch):
    pk = fresh_key(cubic_key)
    g1, g2 = [], []
    monkeypatch.setattr(MSM, "prepare_g1", counted(g1, MSM.prepare_g1))
    monkeypatch.setattr(MSM, "prepare_g2", counted(g2, MSM.prepare_g2))
    pools = at_once([lambda: prepare_queries(pk, "cpu")] * 4)
    assert len(g1) == 4 and len(g2) == 1  # a, b1, l, h; b2
    assert all(p is pools[0] for p in pools)
    assert sorted(pools[0]) == ["a", "b1", "b2", "h", "l"]


def test_launch_count_is_exact():
    saved, interval = dict(cuda.LAUNCHES), sys.getswitchinterval()
    cuda.reset_launches()
    sys.setswitchinterval(1e-6)  # switch threads as often as possible
    try:
        at_once([lambda: [cuda.count("mont_mul") for _ in range(10_000)]]
                * 8)
        got = dict(cuda.LAUNCHES)
    finally:
        sys.setswitchinterval(interval)
        cuda.LAUNCHES.update(saved)
    assert got == {k: 80_000 if k == "mont_mul" else 0 for k in got}


def test_native_mimc_loads_once(monkeypatch):
    binds, warms = [], []
    monkeypatch.setattr(TN, "load", counted(binds, TN.load))
    monkeypatch.setattr(seq_native, "_warm", counted(warms, seq_native._warm))
    seq_native.load.cache_clear()
    libs = at_once([seq_native.load] * 8)
    assert len(binds) == 1 and len(warms) == 1
    assert all(lib is libs[0] for lib in libs)

    rng = np.random.default_rng(17)
    pairs = [[tuple(int.from_bytes(rng.bytes(31), "big") for _ in range(2))
              for _ in range(16)] for _ in range(8)]
    be = lambda v: v.to_bytes(32, "big")
    got = at_once([lambda ps=ps: [int.from_bytes(seq_native.hash2_be(
        be(a), be(b)), "big") for a, b in ps] for ps in pairs])
    assert got == [[JMIMC.hash_2(a, b) for a, b in ps] for ps in pairs]


def test_phase_logs_of_two_threads():
    """Two threads' spans recorded at once are both kept, each tagged with
    its thread and request; work one of them hands to a worker thread
    (trace.carry) keeps that thread's parent and request."""
    both = threading.Barrier(2)

    def on_worker(label):
        with TT.span(f"{label}.worker"):
            pass

    def prove_like(label):
        with TT.span(label, request=label) as outer:
            both.wait()  # both spans open
            with cf.ThreadPoolExecutor(1) as ex:
                ex.submit(TT.carry(on_worker), label).result()
            both.wait()  # both workers' spans in
        return threading.current_thread().name, outer.id

    since = time.perf_counter()
    (one, id_one), (two, id_two) = at_once(
        [lambda: prove_like("one"), lambda: prove_like("two")])
    rows = {r.name: r for r in TT.spans() if r.start >= since}
    assert sorted(rows) == ["one", "one.worker", "two", "two.worker"]
    for label, name, sid in (("one", one, id_one), ("two", two, id_two)):
        assert (rows[label].thread_name, rows[label].request) == (name, label)
        worker = rows[f"{label}.worker"]
        assert (worker.parent, worker.request) == (sid, label)
        assert worker.thread_name != name