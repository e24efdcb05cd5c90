"""Process groups of the multi-card path over torch.distributed.

The JAX package drives every device of a host from one controller over a
``jax.sharding.Mesh``; the port runs one process per rank instead (SPMD),
each on its own card, and every rank runs the same code. A ``Mesh`` here is
a process group with this rank's place in it and its device:

- ``init_distributed``: joins the group that torch's launcher describes
  (``MASTER_ADDR`` / ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
  ``LOCAL_RANK``, as torchrun sets them); one process is a no-op.
- ``init_file_store``: joins a group of ``world`` ranks on this host
  through a file store (no ports), as ``run_local``'s ranks do.
- ``global_mesh``: the ``Mesh`` of the initialized default group;
  ``placement``: the device and mesh of a prover entry point.
- ``host_point_slice``: the point range a host owns of an n-point MSM.
- ``run_local``: spawns ``world`` ranks on this host, runs ``fn(mesh,
  *args)`` on each and returns their results in rank order; the torch
  counterpart of the JAX package's virtual 8-device mesh, for tests and
  for several ranks on one card.

The backend is NCCL for a CUDA device and gloo for the CPU. A caller may
name gloo with a CUDA device: NCCL refuses two ranks on one card, so
several ranks share one card only over gloo (parallel/comm.py then moves
the exchanged tensors through host memory).
"""

from __future__ import annotations

import os
import queue
import tempfile
import time
import traceback
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from ..device import resolve


@dataclass
class Mesh:
    """A process group, its size, this rank, its device and backend.
    ``comm`` holds the host seconds and bytes of this rank's collectives
    (parallel/comm.py adds to it)."""

    group: object
    size: int
    rank: int
    device: torch.device
    backend: str
    comm: dict = field(default_factory=lambda: {"seconds": 0.0,
                                                "bytes": 0, "calls": 0})

    @property
    def key(self) -> tuple:
        """What a shard depends on: the mesh's size, this rank, the
        device."""
        return ("mesh", self.size, self.rank, str(self.device))


def _backend(dev: torch.device, backend) -> str:
    return backend or ("nccl" if dev.type == "cuda" else "gloo")


def _rank_device(dev: torch.device, local: int = None) -> torch.device:
    """cuda:{local mod cards} for a CUDA device (local: LOCAL_RANK by
    default), else dev."""
    if dev.type != "cuda":
        return dev
    if local is None:
        local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


def init_distributed(backend: str = None, device="cuda") -> bool:
    """Join the default process group from torch's launcher environment.
    Returns True when running as several processes; with one (WORLD_SIZE
    unset or 1) it initializes nothing and returns False."""
    dev = resolve(device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return False
    if not dist.is_initialized():
        if dev.type == "cuda":
            torch.cuda.set_device(_rank_device(dev))
        dist.init_process_group(_backend(dev, backend), init_method="env://",
                                world_size=world,
                                rank=int(os.environ["RANK"]))
    return dist.get_world_size() > 1


def init_file_store(path: str, world: int, rank: int, backend: str = None,
                    device="cuda") -> Mesh:
    """Join a default group of `world` ranks on this host through the file
    store at `path` (a fresh file that every rank names); returns this
    rank's Mesh, on cuda:{rank mod cards} or the CPU. With world = 1 it
    makes a one-rank group in this process."""
    dev = _rank_device(resolve(device), rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(_backend(dev, backend),
                            store=dist.FileStore(path, world),
                            world_size=world, rank=rank)
    return Mesh(group=dist.group.WORLD, size=world, rank=rank, device=dev,
                backend=str(dist.get_backend()))


def global_mesh(device="cuda") -> Mesh:
    """The Mesh of the initialized default group: every rank of every
    process, this rank on cuda:{LOCAL_RANK mod cards} (or the CPU)."""
    dev = resolve(device)
    if not dist.is_initialized():
        raise RuntimeError("global_mesh: no process group is initialized "
                           "(init_distributed or init_file_store first)")
    return Mesh(group=dist.group.WORLD, size=dist.get_world_size(),
                rank=dist.get_rank(), device=_rank_device(dev),
                backend=str(dist.get_backend()))


def placement(device, mesh=None) -> tuple:
    """(device, mesh) of a prover entry point: `mesh` if given, else the
    initialized default group's Mesh when it has more than one rank, else
    None (one device); with a mesh, its device, which must be of
    `device`'s type. Raises without a card unless device is the CPU."""
    dev = resolve(device)
    if mesh is None and dist.is_initialized() and dist.get_world_size() > 1:
        mesh = global_mesh(dev)
    if mesh is None:
        return dev, None
    if mesh.device.type != dev.type:
        raise ValueError(f"a mesh on {mesh.device} for a {dev.type} prove")
    return mesh.device, mesh


def host_point_slice(n_total: int, host: int = None,
                     n_hosts: int = None) -> tuple:
    """[start, end) of the points that this host owns of an n_total-point
    MSM: each of n_hosts hosts owns ceil(n_total / n_hosts). By default
    the host is rank // LOCAL_WORLD_SIZE of the initialized group (one
    host when none is)."""
    if host is None or n_hosts is None:
        world = dist.get_world_size() if dist.is_initialized() else 1
        rank = dist.get_rank() if dist.is_initialized() else 0
        local = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
        host, n_hosts = rank // local, -(-world // local)
    per = -(-n_total // n_hosts)
    return host * per, min(n_total, (host + 1) * per)


# ---------------------------------------------------------------------------
# ranks on this host
# ---------------------------------------------------------------------------


def _rank_main(fn, rank, world, backend, device, path, out, args):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    try:
        mesh = init_file_store(path, world, rank, backend, device)
        try:
            out.put((rank, True, fn(mesh, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which re-raises
        out.put((rank, False, traceback.format_exc()))


def run_local(fn, world: int, backend: str = None, device="cuda",
              args: tuple = (), timeout: float = 900.0) -> list:
    """Run fn(mesh, *args) on `world` ranks spawned on this host (the
    spawn start method: no CUDA context is forked), joined through a file
    store in a temporary directory; returns their results in rank order.
    fn must be importable by name (a module-level function) and its
    result picklable. A rank that raises, or dies, fails the call: the
    other ranks are stopped and the first failure is raised here, its
    traceback in the message."""
    dev = resolve(device)
    ctx = torch.multiprocessing.get_context("spawn")
    out = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world, backend, str(dev), path,
                                   out, args))
                 for r in range(world)]
        for p in procs:
            p.start()
        results, failure = {}, None
        deadline = time.monotonic() + timeout
        try:
            while len(results) < world and failure is None:
                try:
                    rank, ok, value = out.get(timeout=1.0)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0)]
                    if dead:
                        failure = (f"rank {dead[0]} exited with code "
                                   f"{procs[dead[0]].exitcode}")
                    elif time.monotonic() > deadline:
                        failure = f"ranks did not finish in {timeout} s"
                    continue
                if ok:
                    results[rank] = value
                else:
                    failure = f"rank {rank} failed:\n{value}"
        finally:
            for p in procs:
                if failure is not None and p.is_alive():
                    p.kill()
                p.join(timeout=60)
                if p.is_alive():
                    p.kill()
                    p.join()
    if failure is not None:
        raise RuntimeError(f"run_local: {failure}")
    return [results[r] for r in range(world)]
