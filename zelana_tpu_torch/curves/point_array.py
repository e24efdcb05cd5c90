"""A batch of affine points kept as numpy limbs.

``PointArray`` holds n affine G1 or G2 points exactly as the npz key format
stores them (``ProvingKey.save_npz``): an (n, comps * 4) uint64 array of
canonical little-endian limbs, comps = 2 for G1 (x, y) and 4 for G2
(x.c0, x.c1, y.c0, y.c1), and an (n,) bool mask of the points at infinity,
whose rows are zero. Keygen produces its query points in this form and the
MSM pools encode them without a Python object per point (a production chunk
key has 5.7M points). As a sequence it yields the usual Python points:
(x, y), ((x0, x1), (y0, y1)), or None for the identity.
"""

from __future__ import annotations

from collections.abc import Sequence

import numpy as np


class PointArray(Sequence):
    def __init__(self, arr: np.ndarray, inf: np.ndarray, comps: int):
        self.arr = np.ascontiguousarray(arr, dtype=np.uint64).reshape(
            -1, comps * 4)
        self.inf = np.ascontiguousarray(inf, dtype=bool)
        self.comps = comps
        assert len(self.inf) == len(self.arr)

    @classmethod
    def from_points(cls, points, comps: int) -> "PointArray":
        if isinstance(points, PointArray):
            return points
        n = len(points)
        vals = []
        for p in points:
            if p is None:
                vals.extend([0] * comps)
            elif comps == 2:
                vals.extend([p[0], p[1]])
            else:
                vals.extend([p[0][0], p[0][1], p[1][0], p[1][1]])
        buf = b"".join(int(v).to_bytes(32, "little") for v in vals)
        arr = np.frombuffer(buf, "<u8").reshape(n, comps * 4)
        return cls(arr, np.array([p is None for p in points], bool), comps)

    def __len__(self) -> int:
        return len(self.arr)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return PointArray(self.arr[i], self.inf[i], self.comps)
        if self.inf[i]:
            return None
        v = [int(x) for x in self.arr[i]]
        c = [v[4 * k] | v[4 * k + 1] << 64 | v[4 * k + 2] << 128
             | v[4 * k + 3] << 192 for k in range(self.comps)]
        return tuple(c) if self.comps == 2 else ((c[0], c[1]), (c[2], c[3]))

    def with_identity_prefix(self, k: int) -> "PointArray":
        """k points at infinity, then these points."""
        return PointArray(
            np.concatenate([np.zeros((k, self.comps * 4), np.uint64),
                            self.arr]),
            np.concatenate([np.ones(k, bool), self.inf]), self.comps)
