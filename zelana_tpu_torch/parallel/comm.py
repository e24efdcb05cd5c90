"""The collectives of the multi-card path, over a parallel.distributed.Mesh.

The counterparts of what the JAX package's shard_map programs call:

- ``ppermute_xor(x, mesh, k)``: x to the partner rank ^ 2^k, the partner's
  x back (``jax.lax.ppermute`` over the pairs (i, i ^ 2^k)), one
  ``dist.batch_isend_irecv`` of a send and a receive;
- ``all_gather(x, mesh)``: every rank's x, in rank order;
  ``all_gather_tiled`` concatenates them along the last axis
  (``jax.lax.all_gather(..., tiled=True)``).

On an NCCL group the tensors stay on the card. On a gloo group, whose
send and receive take CPU tensors only, the exchanged tensors go through
host memory and come back to x's device. The backend's name decides which,
never a caught exception. Each call adds its host seconds and the bytes it
sent to ``mesh.comm``; with NCCL the host seconds are those of the
enqueue, with gloo those of the whole exchange.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist


def _through_host(mesh) -> bool:
    return mesh.backend == "gloo"


def _tally(mesh, t0: float, nbytes: int) -> None:
    mesh.comm["seconds"] += time.perf_counter() - t0
    mesh.comm["bytes"] += nbytes
    mesh.comm["calls"] += 1


def ppermute_xor(x: torch.Tensor, mesh, k: int) -> torch.Tensor:
    """Send x to rank ^ 2^k and return what that rank sent here."""
    t0 = time.perf_counter()
    partner = mesh.rank ^ (1 << k)
    if partner >= mesh.size:
        raise ValueError(f"ppermute_xor: no partner {partner} in a mesh of "
                         f"{mesh.size}")
    send = x.contiguous()
    if _through_host(mesh):
        send = send.cpu()
    recv = torch.empty_like(send)
    # the mesh's group is the default group: its ranks are global ranks
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, partner, mesh.group),
        dist.P2POp(dist.irecv, recv, partner, mesh.group)])
    for r in reqs:
        r.wait()
    out = recv.to(x.device)
    _tally(mesh, t0, send.numel() * send.element_size())
    return out


def all_gather(x: torch.Tensor, mesh) -> list:
    """[x of rank 0, x of rank 1, ...], each on x's device."""
    t0 = time.perf_counter()
    send = x.contiguous()
    if _through_host(mesh):
        send = send.cpu()
    parts = [torch.empty_like(send) for _ in range(mesh.size)]
    dist.all_gather(parts, send, group=mesh.group)
    out = [p.to(x.device) for p in parts]
    _tally(mesh, t0, send.numel() * send.element_size())
    return out


def all_gather_tiled(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's x concatenated along the last axis, in rank order."""
    return torch.cat(all_gather(x, mesh), dim=-1)
