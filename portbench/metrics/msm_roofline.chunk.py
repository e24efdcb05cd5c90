"""The chunk proofs' MSMs against their roofline: the least time of the
work the window's MSMs need, over the device time of the MSM kernels in
the window (%), over the profiler windows that kept all their kernels.

The work is counted from the data, whatever kernel does it: for each MSM
(a, b1, l and h in G1 and b2 in G2 of every proof), each point that is not
the identity and whose scalar has a nonzero 8-bit digit in a window is
added into that window's bucket: the adds are the nonzero digits less the
distinct nonzero digits of each window (a bucket's first point is a copy),
at the fewest Montgomery products of a mixed add that PERF.md §3 lists (a
tape step's: G1 9, G2 30), 264 int32 operations a product; the bytes are
those points' affine coordinates, read once (G1 64, G2 128). The bucket
sums' reduction (about 2 x 255 adds a window) is left out. The least time
of each MSM is the larger of its bytes at 3.35 TB/s and its operations at
the derived int32 rate (frozen.bound_ms); the scalars are read from the
program's scalar_digits calls (the z digits once a proof for the four z
MSMs, the h digits once), the identities from the proving key's query
pools.
"""

import numpy as np

from portbench import frozen
from portbench.harness import device_ms, kept_windows

HOOKS = [("zelana_tpu_torch.ops.msm_scan", "scalar_digits", "args")]
MSM_KERNELS = ("runscan_kernel", "bucket_merge_kernel", "bucket_tree_kernel")
ADD_PRODUCTS = {"g1": 9, "g2": 30}
POINT_BYTES = {"g1": 64, "g2": 128}


def limbs_of(scalars) -> np.ndarray:
    if isinstance(scalars, np.ndarray):
        return np.ascontiguousarray(scalars, dtype=np.uint64)
    buf = b"".join(int(s).to_bytes(32, "little") for s in scalars)
    return np.frombuffer(buf, dtype="<u8").reshape(-1, 4)


def msm_least_ms(digits: np.ndarray, curve: str) -> float:
    """digits: (n, 32) uint8 window digits of the MSM's non-identity
    points."""
    nnz = np.count_nonzero(digits, axis=0)
    distinct = sum(int(np.count_nonzero(np.bincount(digits[:, w],
                                                    minlength=256)[1:]))
                   for w in range(digits.shape[1]))
    adds = int(nnz.sum()) - distinct
    points = int(np.count_nonzero(digits.any(axis=1)))
    ops = adds * ADD_PRODUCTS[curve] * frozen.MUL_OPS
    return frozen.bound_ms(points * POINT_BYTES[curve], ops)[0]


def read(run):
    from zelana_tpu_torch.groth16.keys import prepare_queries

    kept = kept_windows(run)
    calls = run.hooks.args.get("scalar_digits", []) if run.hooks else []
    if not kept or not calls:
        return None
    keep = {run.windows.index(w) for w in kept}
    pools = prepare_queries(run.session.pk, run.session.prover.device)
    least = 0.0
    for window, scalars in calls:
        if window not in keep:
            continue
        digits = limbs_of(scalars).view(np.uint8).reshape(-1, 32)
        for _name, (_words, inf, curve) in pools.items():
            if len(inf) == len(digits):
                least += msm_least_ms(digits[~inf], curve)
    spent = device_ms(kept, MSM_KERNELS)
    return 100 * least / spent if spent else None
