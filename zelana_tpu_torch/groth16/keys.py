"""Groth16 key and proof containers + arkworks-compatible (de)serialization.

Byte layout matches ark-groth16 =0.5.0 `CanonicalSerialize` compressed mode,
which is the format of the reference's key files and golden artifacts
(prover/l2_vk.json, prover/l2_proof.json; written by prover/src/bin/keygen.rs
and prover/src/main.rs.bak export fns):

    VerifyingKey: alpha_g1(32) beta_g2(64) gamma_g2(64) delta_g2(64)
                  u64-LE len || gamma_abc_g1[len] (32 each)
    Proof:        a(32, G1) b(64, G2) c(32, G1)
    ProvingKey:   vk || beta_g1 delta_g1 || vec a_query || vec b_g1_query
                  || vec b_g2_query || vec h_query || vec l_query
"""

from __future__ import annotations

import functools
import struct
import threading
from dataclasses import dataclass, field
from typing import List, Sequence

from ..curves import g1, g2
from ..curves.point_array import PointArray


@dataclass
class VerifyingKey:
    alpha_g1: tuple
    beta_g2: tuple
    gamma_g2: tuple
    delta_g2: tuple
    gamma_abc_g1: List[tuple]

    def serialize_compressed(self) -> bytes:
        out = bytearray()
        out += g1.serialize_compressed(self.alpha_g1)
        out += g2.serialize_compressed(self.beta_g2)
        out += g2.serialize_compressed(self.gamma_g2)
        out += g2.serialize_compressed(self.delta_g2)
        out += struct.pack("<Q", len(self.gamma_abc_g1))
        for pt in self.gamma_abc_g1:
            out += g1.serialize_compressed(pt)
        return bytes(out)

    @classmethod
    def deserialize_compressed(cls, data: bytes) -> "VerifyingKey":
        off = 0
        alpha = g1.deserialize_compressed(data[off : off + 32]); off += 32
        beta = g2.deserialize_compressed(data[off : off + 64]); off += 64
        gamma = g2.deserialize_compressed(data[off : off + 64]); off += 64
        delta = g2.deserialize_compressed(data[off : off + 64]); off += 64
        (n,) = struct.unpack("<Q", data[off : off + 8]); off += 8
        ic = []
        for _ in range(n):
            ic.append(g1.deserialize_compressed(data[off : off + 32])); off += 32
        assert off == len(data), f"trailing bytes: {len(data) - off}"
        return cls(alpha, beta, gamma, delta, ic)


@dataclass
class Proof:
    a: tuple  # G1
    b: tuple  # G2
    c: tuple  # G1

    def serialize_compressed(self) -> bytes:
        return (
            g1.serialize_compressed(self.a)
            + g2.serialize_compressed(self.b)
            + g1.serialize_compressed(self.c)
        )

    @classmethod
    def deserialize_compressed(cls, data: bytes) -> "Proof":
        assert len(data) == 128
        return cls(
            g1.deserialize_compressed(data[0:32]),
            g2.deserialize_compressed(data[32:96]),
            g1.deserialize_compressed(data[96:128]),
        )


@dataclass
class ProvingKey:
    vk: VerifyingKey
    beta_g1: tuple
    delta_g1: tuple
    # each query: a list of points or a PointArray
    a_query: Sequence = field(default_factory=list)
    b_g1_query: Sequence = field(default_factory=list)
    b_g2_query: Sequence = field(default_factory=list)
    h_query: Sequence = field(default_factory=list)
    l_query: Sequence = field(default_factory=list)

    def serialize_compressed(self) -> bytes:
        out = bytearray()
        out += self.vk.serialize_compressed()
        out += g1.serialize_compressed(self.beta_g1)
        out += g1.serialize_compressed(self.delta_g1)
        for vec, ser in (
            (self.a_query, g1.serialize_compressed),
            (self.b_g1_query, g1.serialize_compressed),
            (self.b_g2_query, g2.serialize_compressed),
            (self.h_query, g1.serialize_compressed),
            (self.l_query, g1.serialize_compressed),
        ):
            out += struct.pack("<Q", len(vec))
            for pt in vec:
                out += ser(pt)
        return bytes(out)

    @classmethod
    def deserialize_compressed(cls, data: bytes) -> "ProvingKey":
        # VK first: parse field by field to find its extent
        off = 0
        alpha = g1.deserialize_compressed(data[off : off + 32]); off += 32
        beta2 = g2.deserialize_compressed(data[off : off + 64]); off += 64
        gamma2 = g2.deserialize_compressed(data[off : off + 64]); off += 64
        delta2 = g2.deserialize_compressed(data[off : off + 64]); off += 64
        (n,) = struct.unpack("<Q", data[off : off + 8]); off += 8
        ic = []
        for _ in range(n):
            ic.append(g1.deserialize_compressed(data[off : off + 32])); off += 32
        vk = VerifyingKey(alpha, beta2, gamma2, delta2, ic)
        beta_g1 = g1.deserialize_compressed(data[off : off + 32]); off += 32
        delta_g1 = g1.deserialize_compressed(data[off : off + 32]); off += 32

        def read_vec(off, size, deser):
            (m,) = struct.unpack("<Q", data[off : off + 8])
            off += 8
            vec = []
            for _ in range(m):
                vec.append(deser(data[off : off + size]))
                off += size
            return vec, off

        a_query, off = read_vec(off, 32, g1.deserialize_compressed)
        b_g1_query, off = read_vec(off, 32, g1.deserialize_compressed)
        b_g2_query, off = read_vec(off, 64, g2.deserialize_compressed)
        h_query, off = read_vec(off, 32, g1.deserialize_compressed)
        l_query, off = read_vec(off, 32, g1.deserialize_compressed)
        assert off == len(data)
        return cls(vk, beta_g1, delta_g1, a_query, b_g1_query, b_g2_query, h_query, l_query)

    # -- raw (uncompressed) numpy cache -------------------------------------
    #
    # Compressed arkworks deserialization recovers y with one modular sqrt
    # PER POINT -- fine for wire-format fidelity, ruinous for loading a
    # production proving key (the 8/4/4 chunk key holds ~5.7M points; ~90
    # minutes of host sqrt). The npz cache stores full (x, y) coordinates
    # as u64 limb arrays: save/load in tens of seconds. Local artifact
    # cache only; the wire format stays arkworks-compressed.

    def to_arrays(self) -> dict:
        """The arrays save_npz writes (the inverse of
        proving_key_from_arrays)."""
        arrs = {}
        for name, vec, comps in (
            ("a", self.a_query, 2), ("b1", self.b_g1_query, 2),
            ("b2", self.b_g2_query, 4), ("h", self.h_query, 2),
            ("l", self.l_query, 2), ("ic", self.vk.gamma_abc_g1, 2),
        ):
            pa = PointArray.from_points(vec, comps)
            arrs[name], arrs[name + "_inf"] = pa.arr, pa.inf
        arrs["fixed_g1"] = PointArray.from_points(
            [self.vk.alpha_g1, self.beta_g1, self.delta_g1], 2).arr
        arrs["fixed_g2"] = PointArray.from_points(
            [self.vk.beta_g2, self.vk.gamma_g2, self.vk.delta_g2], 4).arr
        return arrs

    def save_npz(self, path: str):
        import numpy as np

        arrs = self.to_arrays()
        # temp + atomic rename: an interrupted keygen must not leave a
        # truncated cache that the next run trusts (matches the .so build
        # pattern in r1cs/native_synth.py)
        import os

        tmp = path + f".tmp{os.getpid()}"
        try:
            with open(tmp, "wb") as f:
                np.savez(f, **arrs)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    @classmethod
    def load_npz(cls, path: str) -> "ProvingKey":
        import numpy as np

        with np.load(path) as z:
            return proving_key_from_arrays(z)


def proving_key_from_arrays(arrays) -> ProvingKey:
    """The key from the arrays of the npz key format (save_npz): `a`, `b1`,
    `b2`, `h`, `l`, `ic` as (n, comps * 4) u64 limbs of affine coordinates
    with their `_inf` masks, plus `fixed_g1` (alpha, beta, delta) and
    `fixed_g2` (beta, gamma, delta). Any mapping of names to arrays works,
    e.g. an opened np.load of a key the JAX package saved. The query
    vectors stay PointArrays (no Python object per point)."""
    import numpy as np

    vecs = {
        name: PointArray(arrays[name], arrays[name + "_inf"], comps)
        for name, comps in (("a", 2), ("b1", 2), ("b2", 4),
                            ("h", 2), ("l", 2), ("ic", 2))
    }
    fixed = PointArray(arrays["fixed_g1"], np.zeros(3, bool), 2)
    fixed2 = PointArray(arrays["fixed_g2"], np.zeros(3, bool), 4)
    vk = VerifyingKey(
        alpha_g1=fixed[0], beta_g2=fixed2[0], gamma_g2=fixed2[1],
        delta_g2=fixed2[2], gamma_abc_g1=list(vecs["ic"]))
    return ProvingKey(vk=vk, beta_g1=fixed[1], delta_g1=fixed[2],
                      a_query=vecs["a"], b_g1_query=vecs["b1"],
                      b_g2_query=vecs["b2"], h_query=vecs["h"],
                      l_query=vecs["l"])


_PREPARE_LOCK = threading.Lock()  # held while a key's pools are built


def prepare_queries(pk: ProvingKey, device="cuda", mesh=None) -> dict:
    """Device-resident query pools of `pk`, built once per device (or, with
    a parallel.distributed.Mesh, once per mesh: this rank's shards) and
    cached on the key. Identity points are stored as the generator
    (corrected at msm_end). The l pool is prefix-padded with one identity
    slot per instance variable (len(gamma_abc_g1) of them), so it is
    indexed by the full assignment z and the a, b1 and l MSMs share one
    schedule set. Proves on several threads that reach a key's device
    first wait for one build of its pools."""
    from ..device import resolve
    from ..ops import msm_scan as MSM

    dev = resolve(device)
    cache = pk.__dict__.setdefault("_prepared", {})
    key = str(dev) if mesh is None else mesh.key
    if key in cache:
        return cache[key]
    with _PREPARE_LOCK:
        if key in cache:
            return cache[key]
        ni = len(pk.vk.gamma_abc_g1)
        l_pts = PointArray.from_points(pk.l_query, 2).with_identity_prefix(ni)
        if mesh is None:
            on_g1 = functools.partial(MSM.prepare_g1, device=dev)
            on_g2 = functools.partial(MSM.prepare_g2, device=dev)
        else:
            from ..parallel import sharded as SH

            on_g1 = functools.partial(SH.prepare_g1_sharded, mesh=mesh)
            on_g2 = functools.partial(SH.prepare_g2_sharded, mesh=mesh)
        cache[key] = {"a": on_g1(pk.a_query), "b1": on_g1(pk.b_g1_query),
                      "b2": on_g2(pk.b_g2_query), "l": on_g1(l_pts),
                      "h": on_g1(pk.h_query)}
        return cache[key]
