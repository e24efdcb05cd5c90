"""The prover's work sharded over the ranks of a Mesh (parallel/distributed.py).

The port's counterpart of the JAX package's ``parallel/sharded.py``. There
one controller runs shard_map programs over a device mesh; here every rank
is a process of its own that runs the same code on its own shard, and the
exchanges go through parallel/comm.py (NCCL on the cards, or gloo through
host memory). Each rank gets the same answer back.

- ``sharded_msm``: the Jacobian windowed MSM (ops/msm.py) on each rank's
  block of the points, then an all_gather of the one-point results, folded
  in rank order with ``jac_add`` (``curve_ops.point_add``).
- ``sharded_mimc_hash2``: hash2_batch on each rank's block of the batch;
  an all_gather returns the whole batch on every rank.
- ``sharded_ntt`` / ``sharded_intt``: one transform of n elements
  block-sharded over D ranks. Rank d runs the first log(n/D) stages on its
  block with the pass kernel (``ntt.block_stages``), then each of the last
  log D stages as one exchange with rank d ^ 2^k (``comm.ppermute_xor``)
  and one ``ntt_cross`` launch; the inverse's 1/n comes with the last one.
  Returns this rank's block of the natural-order result.
- ``sharded_msm_scan``, ``prepare_g1_sharded`` / ``prepare_g2_sharded``,
  ``shard_schedules``, ``msm_begin_sharded``: the run-scan MSM
  (ops/msm_scan.py) with the points split into equal shards, each rank
  preparing only its own. A rank runs each segment of its shard up to its
  dense (C, 8,192) buckets (``msm_scan.device_merged``) and adds the
  segments up on its device; the ranks' arrays then reduce by recursive
  halving (log D exchanges of halving width, each followed by
  ``merge_pairs``: bucket_merge with K = 2), a tiled all_gather gives every
  rank the global buckets, and ``bucket_tree`` and the host's Horner
  (msm_scan.msm_end) finish as on one device. As there, identity points
  are stored as the generator and corrected once on the host
  (msm_scan._inf_correction over the global digits), so one schedule set
  of a shard serves every pool with the same scalars (the prover's a, b1,
  l and b2 queries); the padding of the last shard gets zero digits.

The stream shapes are the port's own (32,768 level-1 lanes, the level-2
scan included) on every shard; the JAX package's level2=False and its K
padding exist only so that XLA compiles one program shape. Segments are
at most ``chunk_n`` points (msm_scan.CHUNK_N by default), a parameter: a
patched module constant would not reach spawned ranks.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..curves.point_array import PointArray
from ..hashes.mimc_batch import hash2_batch
from ..ops import curve_kernels as CK
from ..ops import curve_ops as CO
from ..ops import msm as MJ
from ..ops import msm_scan as MSM
from ..ops import ntt as NTT
from . import comm
from . import distributed as D


def make_mesh(device="cuda") -> D.Mesh:
    """The Mesh of the initialized default group (distributed.global_mesh)."""
    return D.global_mesh(device)


def _log_size(mesh) -> int:
    if mesh.size & (mesh.size - 1):
        raise ValueError(f"a mesh of {mesh.size} ranks: the exchanges need "
                         f"a power of two")
    return mesh.size.bit_length() - 1


def _block(n: int, mesh) -> tuple:
    """[lo, hi) of this rank's block of n items; n % size == 0."""
    if n % mesh.size:
        raise ValueError(f"{n} items do not split over {mesh.size} ranks")
    per = n // mesh.size
    return mesh.rank * per, (mesh.rank + 1) * per


# ---------------------------------------------------------------------------
# the Jacobian MSM, the hash batch, the transform
# ---------------------------------------------------------------------------


def sharded_msm(pool: torch.Tensor, digits: np.ndarray, mesh,
                curve: str = "g1") -> torch.Tensor:
    """pool (VC, N) affine words (msm_scan.prepare_g1 / prepare_g2), digits
    (32, N) window digits, N % size == 0 -> the (C, 1) Jacobian words of
    the MSM, the same on every rank."""
    lo, hi = _block(digits.shape[1], mesh)
    local = MJ._msm(pool[:, lo:hi].to(mesh.device).contiguous(),
                    digits[:, lo:hi], curve)
    parts = comm.all_gather(local, mesh)
    acc = parts[0]
    for p in parts[1:]:
        acc = CO.jac_add(acc, p, curve)
    return acc


def sharded_mimc_hash2(a: torch.Tensor, b: torch.Tensor,
                       mesh) -> torch.Tensor:
    """Batched MiMC hash_2 of (8, n) Montgomery words, n % size == 0, the
    batch split over the ranks; the whole (8, n) result on every rank."""
    lo, hi = _block(a.shape[1], mesh)
    dev = mesh.device
    local = hash2_batch(a[:, lo:hi].to(dev).contiguous(),
                        b[:, lo:hi].to(dev).contiguous())
    return comm.all_gather_tiled(local, mesh)


def sharded_ntt(x: torch.Tensor, plan: NTT.NttPlan, mesh,
                inverse: bool = False) -> torch.Tensor:
    """The NTT (iNTT) of x, (8, n) words whole on every rank, block-sharded
    over the mesh: returns this rank's block, columns [rank m, (rank + 1)
    m) of the natural-order result, m = n / size (all_gather_tiled for the
    whole transform)."""
    log_d = _log_size(mesh)
    d, m = mesh.rank, plan.n // mesh.size
    xs = NTT.block_stages(x.to(mesh.device), plan, mesh.size, d, inverse)
    twst = plan.on(mesh.device)["twi_st" if inverse else "tw_st"]
    for k in range(log_d):
        recv = comm.ppermute_xor(xs, mesh, k)
        last = inverse and k == log_d - 1
        xs = NTT.ntt_cross(xs, recv, twst, NTT.cross_twiddle_column(m, k, d),
                           (d >> k) & 1, plan.n_inv if last else None)
    return xs


def sharded_intt(x: torch.Tensor, plan: NTT.NttPlan, mesh) -> torch.Tensor:
    return sharded_ntt(x, plan, mesh, inverse=True)


# ---------------------------------------------------------------------------
# the run-scan MSM over point shards
# ---------------------------------------------------------------------------


@dataclass
class ShardedPool:
    """This rank's shard of a fixed point basis."""

    pool: torch.Tensor  # (VC, shard) affine words on the mesh's device
    inf: np.ndarray  # (n,) bool over all ranks: the identity points, which
    # the pools hold as the generator (msm_scan.prepare_g1)
    curve: str
    n: int  # points over all ranks
    shard: int  # points a rank, ceil(n / size)


def _shard_range(n: int, mesh) -> tuple:
    """(shard, lo, hi): ceil(n / size) points a rank, this rank's points
    [lo, hi) of the n; the last shard's hi - lo may fall short."""
    shard = -(-n // mesh.size)
    lo = min(n, mesh.rank * shard)
    return shard, lo, min(n, lo + shard)


def _prepare_sharded(points, mesh, curve: str) -> ShardedPool:
    """Encode and upload this rank's shard of `points` (a list or a
    PointArray), the last shard padded with identity slots."""
    comps = 2 if curve == "g1" else 4
    n = len(points)
    shard, lo, hi = _shard_range(n, mesh)
    mine = PointArray.from_points(points[lo:hi], comps)
    pad = shard - (hi - lo)
    if pad:
        mine = PointArray(
            np.concatenate([mine.arr, np.zeros((pad, 4 * comps), np.uint64)]),
            np.concatenate([mine.inf, np.ones(pad, bool)]), comps)
    prep = MSM.prepare_g1 if curve == "g1" else MSM.prepare_g2
    inf = (points.inf if isinstance(points, PointArray) else
           np.fromiter((p is None for p in points), bool, n))
    return ShardedPool(prep(mine, mesh.device)[0], inf, curve, n, shard)


def prepare_g1_sharded(points, mesh) -> ShardedPool:
    return _prepare_sharded(points, mesh, "g1")


def prepare_g2_sharded(points, mesh) -> ShardedPool:
    return _prepare_sharded(points, mesh, "g2")


def shard_schedules(digits: np.ndarray, n: int, mesh,
                    chunk_n: int = None) -> list:
    """The segment schedules (msm_scan.build_segment_schedules, chunk_n
    points at most a segment) of this rank's shard of the first n columns
    of `digits` ((32, >= n) window digits), zero past n (the last shard's
    padding). One list serves every sharded pool of n points with these
    scalars."""
    if digits.shape[1] < n:
        raise ValueError(f"{digits.shape[1]} digit columns for {n} points")
    shard, lo, hi = _shard_range(n, mesh)
    out = np.zeros((MSM.SCAN_WINDOWS, shard), np.int32)
    out[:, :hi - lo] = digits[:, lo:hi]
    return MSM.build_segment_schedules(out, chunk_n=chunk_n)


def reduce_buckets(merged: torch.Tensor, mesh, curve: str) -> torch.Tensor:
    """Sum the ranks' dense (C, 8192) bucket arrays and form the 256
    bit-subset sums, the same on every rank. Recursive halving: at step k
    (bit b = log D - 1 - k, the top bit first) a rank keeps the half its
    bit b selects, sends the other to rank ^ 2^b and adds what comes back
    (merge_pairs); after log D steps rank r holds block r of the sums, in
    natural order, and a tiled all_gather joins them."""
    for b in range(_log_size(mesh) - 1, -1, -1):
        half = merged.shape[1] // 2
        lower, upper = merged[:, :half], merged[:, half:]
        bit = (mesh.rank >> b) & 1
        send, keep = (lower, upper) if bit else (upper, lower)
        merged = CK.merge_pairs(keep, comm.ppermute_xor(send, mesh, b), curve)
    if mesh.size > 1:
        merged = comm.all_gather_tiled(merged, mesh)
    return CK.bucket_tree(merged.contiguous(), curve)


def msm_begin_scheds_sharded(prepared: ShardedPool, segs: list, mesh,
                             corr: int = 0):
    """The sharded twin of msm_scan.msm_begin_scheds: each segment of this
    rank's shard (segs: shard_schedules of its scalars) up to its dense
    buckets, the segments added up on the device, then reduce_buckets
    across the ranks. corr: the pool's identity-slot correction
    (msm_scan._inf_correction over the global digits), applied once at
    msm_scan.msm_end."""
    sp = prepared
    if segs[-1]["hi"] != sp.shard:
        raise ValueError(f"schedules of {segs[-1]['hi']} points for a shard "
                         f"of {sp.shard}")
    MSM.upload_segment_schedules(segs, mesh.device)
    merged = None
    for seg in segs:
        part = MSM.device_merged(sp.pool[:, seg["lo"]:seg["hi"]], seg["dev"],
                                 sp.curve)
        merged = part if merged is None else CK.merge_pairs(merged, part,
                                                            sp.curve)
    multi = MSM._MultiMsm()
    multi.pending.append(reduce_buckets(merged, mesh, sp.curve))
    return (multi, sp.curve, corr)


def msm_begin_sharded(prepared: ShardedPool, scalars, mesh, digits=None,
                      chunk_n: int = None):
    """The sharded twin of msm_scan.msm_begin. `digits`: the (32, >= n)
    digits of the scalars, or None to take them from `scalars`; chunk_n:
    None for msm_scan.CHUNK_N. Returns a handle for msm_scan.msm_end."""
    if digits is None:
        digits = MSM.scalar_digits(scalars)
    n = prepared.n
    return msm_begin_scheds_sharded(
        prepared, shard_schedules(digits, n, mesh, chunk_n), mesh,
        MSM._inf_correction(digits[:, :n], prepared.inf))


def sharded_msm_scan(points, scalars, mesh, curve: str = "g1"):
    """The run-scan MSM of points and scalars over the mesh: the affine
    result (None for the identity), the same on every rank."""
    prep = _prepare_sharded(points, mesh, curve)
    return MSM.msm_end(msm_begin_sharded(prep, scalars, mesh))
