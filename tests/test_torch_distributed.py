"""zelana_tpu_torch/parallel/distributed.py: process groups on one host,
against the JAX package's parallel/distributed.py where it has a
counterpart. Four gloo ranks on the CPU (run_local) are spawned once per
module and run every check of tests/torch_mesh_ranks.py:
distributed_checks."""

import jax
import pytest
import torch

import torch_mesh_ranks as R
from zelana_tpu.parallel import distributed as JD
from zelana_tpu_torch.parallel import distributed as D

torch.set_num_threads(1)

SLICE_CASES = [(1 << 24, 8), (1 << 20, 4), (100, 8), (7, 8), (1, 2),
               (65536, 3)]


@pytest.fixture(scope="module")
def world4():
    return D.run_local(R.distributed_checks, 4, "gloo", "cpu",
                       ([n for n, _ in SLICE_CASES],), 300.0)


def test_init_distributed_single_process_is_noop(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "JAX_COORDINATOR_ADDRESS",
                "JAX_NUM_PROCESSES"):
        monkeypatch.delenv(var, raising=False)
    assert JD.init_distributed() is False
    assert D.init_distributed(device="cpu") is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert D.init_distributed(device="cpu") is False
    assert not torch.distributed.is_initialized()
    assert D.placement("cpu") == (torch.device("cpu"), None)


def test_global_mesh_runs_an_all_reduce(world4):
    """Every rank sees the whole group: 1 + 2 + 3 + 4 = 10, its own rank,
    the gloo backend on the CPU; with a group of more than one rank the
    prover's placement takes it as the mesh."""
    assert [r["rank"] for r in world4] == [0, 1, 2, 3]
    for r in world4:
        assert r["all_reduce"] == 10.0
        assert (r["size"], r["device"], r["backend"]) == (4, "cpu", "gloo")
        assert r["placement"]


def test_host_point_slice_one_host_in_a_group(world4):
    """run_local's ranks are one host: each owns every point."""
    for r in world4:
        assert r["slices"] == [(0, n) for n, _ in SLICE_CASES]


@pytest.mark.parametrize("n_total,n_hosts", SLICE_CASES)
def test_host_point_slice_matches_jax(monkeypatch, n_total, n_hosts):
    """The same slices as the JAX function under the same host index and
    count (tests/test_distributed.py's cases), and they tile [0, n_total):
    disjoint, ordered, complete, none over ceil(n / hosts)."""
    slices = []
    for h in range(n_hosts):
        monkeypatch.setattr(jax, "process_index", lambda h=h: h)
        monkeypatch.setattr(jax, "process_count", lambda: n_hosts)
        got = D.host_point_slice(n_total, host=h, n_hosts=n_hosts)
        assert got == JD.host_point_slice(n_total)
        slices.append(got)
    covered = 0
    for lo, hi in slices:
        assert lo <= hi <= n_total
        assert lo == min(covered, n_total)
        covered = max(covered, hi)
    assert covered == n_total
    per = -(-n_total // n_hosts)
    assert all(hi - lo <= per for lo, hi in slices)


def test_host_point_slice_without_a_group():
    assert D.host_point_slice(12345) == (0, 12345)


def test_run_local_reraises_a_failing_rank():
    with pytest.raises(RuntimeError, match="(?s)rank 1 failed.*on purpose"):
        D.run_local(R.failing_rank, 2, "gloo", "cpu", timeout=120.0)


def test_placement_refuses_a_mesh_on_another_device():
    mesh = D.Mesh(group=None, size=2, rank=0, device=torch.device("meta"),
                  backend="gloo")
    with pytest.raises(ValueError, match="mesh on meta"):
        D.placement("cpu", mesh)
    cpu_mesh = D.Mesh(group=None, size=2, rank=1,
                      device=torch.device("cpu"), backend="gloo")
    assert D.placement("cpu", cpu_mesh) == (torch.device("cpu"), cpu_mesh)
