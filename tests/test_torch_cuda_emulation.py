"""The port's point kernels (zelana_tpu_torch/csrc/curve_kernels.cu) built
with g++ over a CPU stand-in for the CUDA runtime (tests/cuda_emu: a fiber
per CUDA thread, barriers, shared memory, the PTX carry flag) and
run on host memory, against their plain PyTorch versions: `step` in one
round and in several (one thread per subtree), general and mixed, and the
bucket tail's two kernels (six threads per complete add, four barriers an
add). This holds the kernels' indexing, their barriers and their shared
memory before a card sees them; the card runs the same comparison in
chip_smoke.py. Equality is exact."""

import ctypes
import os
import re
import subprocess

import numpy as np
import pytest
import torch

from zelana_tpu_torch.fields.bn254 import P
from zelana_tpu_torch.ops import curve_kernels as CK
from zelana_tpu_torch.ops import cuda
from zelana_tpu_torch.ops import limbs as L

torch.set_num_threads(1)  # many small int64 ops: threads only contend

EMU = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda_emu")


@pytest.fixture(scope="module")
def lib():
    """curve_kernels.cu rewritten for the stand-in and built with g++."""
    out = os.path.join(cuda.BUILD, "emu")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(cuda.CSRC, "field.cuh")) as f:
        field = f.read()
    field, n = re.subn(r"namespace ptx \{.*\}  // namespace ptx",
                       "namespace ptx = emu_ptx;", field, flags=re.S)
    assert n == 1, "field.cuh: no ptx namespace to replace"
    with open(os.path.join(cuda.CSRC, "curve_kernels.cu")) as f:
        src = f.read()
    src, n = re.subn(r"(\w+<[^<>]*>)\s*<<<([^>]*)>>>\s*\(([^;]*)\);",
                     r"emu_launch(\2, [&] { \1(\3); });", src, flags=re.S)
    assert n >= 10, "curve_kernels.cu: kernel launches not found"
    src = src.replace("extern __shared__ u32 sm[];",
                      "u32* sm = emu_dyn.data();")
    for name, text in (("field.cuh", field), ("curve_kernels.cpp", src)):
        with open(os.path.join(out, name), "w") as f:
            f.write(text)
    so = os.path.join(out, "libcurve_kernels_emu.so")
    tmp = f"{so}.tmp{os.getpid()}"
    subprocess.run(["g++", "-std=c++20", "-O2", "-shared", "-fPIC",
                    "-w", f"-I{EMU}", f"-I{out}", "-o", tmp,
                    os.path.join(out, "curve_kernels.cpp")], check=True)
    os.replace(tmp, so)
    cdll = ctypes.CDLL(so)
    cuda._declare(cdll)
    return cdll


def _rand_words(rng, C: int, n: int) -> torch.Tensor:
    """(C, n) words of random canonical Fq elements (the adds are
    straight-line formulas: any field elements compare word for word)."""
    vals = [int.from_bytes(rng.bytes(32), "little") % P
            for _ in range(C // 8 * n)]
    return L.to_tensor(np.concatenate(
        [L.encode_mont(vals[k * n:(k + 1) * n], L.FQ)
         for k in range(C // 8)]), "cpu")


@pytest.mark.parametrize("curve,rounds,by_ids,mixed", [
    ("g1", 1, True, False), ("g1", 5, False, True), ("g1", 3, True, False),
    ("g2", 1, False, True), ("g2", 5, True, False), ("g2", 2, True, True)])
def test_emulated_step_matches_plain(lib, curve, rounds, by_ids, mixed):
    """S = 352 round-0 adds: 352 / 2^(rounds-1) subtrees, the last block
    of 64 threads partial. The whole pool is compared, so slots outside
    the write block must come back untouched."""
    rng = np.random.default_rng(71 + rounds + 8 * (curve == "g2"))
    C, S = CK.rows(curve), 352
    pool = _rand_words(rng, C, 3 * S + 16)
    ia = ib = None
    if by_ids:
        ia, ib = (torch.from_numpy(rng.integers(0, 2 * S, S).astype(
            np.int32)) for _ in range(2))
    got, want = pool.clone(), pool.clone()
    rc = lib.zt_step(0 if curve == "g1" else 1, int(mixed), got.data_ptr(),
                     None if ia is None else ia.data_ptr(),
                     None if ib is None else ib.data_ptr(), 0, 2 * S, S,
                     got.shape[1], rounds, None)
    assert rc == 0
    CK.step_plain(want, 2 * S, S, curve, ia, ib, 0, mixed, rounds)
    assert torch.equal(got, want)


@pytest.mark.parametrize("curve,K", [("g1", 3), ("g2", 2)])
def test_emulated_bucket_tail_matches_plain(lib, curve, K):
    """bucket_merge then bucket_tree over a (C, 512) emit and K dense
    layers of random columns, against bucket_tail_plain."""
    rng = np.random.default_rng(81 + K)
    C, nb = CK.rows(curve), 8192
    emit2 = _rand_words(rng, C, 512)
    dense = torch.from_numpy(rng.integers(0, 512, K * nb).astype(np.int32))
    merged = torch.empty((C, nb), dtype=torch.int32)
    out = torch.empty((C, 256), dtype=torch.int32)
    cid = 0 if curve == "g1" else 1
    assert lib.zt_bucket_merge(cid, emit2.data_ptr(), emit2.shape[1],
                               dense.data_ptr(), K, nb, merged.data_ptr(),
                               None) == 0
    assert lib.zt_bucket_tree(cid, merged.data_ptr(), nb, out.data_ptr(),
                              None) == 0
    assert torch.equal(out, CK.bucket_tail_plain(emit2, dense, K, curve))
