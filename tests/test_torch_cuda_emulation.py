"""The port's kernels (zelana_tpu_torch/csrc/curve_kernels.cu and
field_kernels.cu) built with g++ over a CPU stand-in for the CUDA runtime
(tests/cuda_emu: a fiber per CUDA thread, barriers, shared memory, the PTX
carry flag, asynchronous copies that land only at their wait) and run on
host memory, against their plain PyTorch versions: `step` in one round and
in several (one thread per subtree), general and mixed, the bucket tail's
two kernels (six threads per complete add, four barriers an add), the
safegcd base inverse over the three fields, inv_fwd in both of its thread
mappings (a thread a chain behind a cp.async ring; a prefix scan over a
thread per element), inv_bwd in both of its (two threads a chain behind a
cp.async ring; a suffix scan), both on inputs with zeros, and the NTT pass
kernel (ntt_kernels.cu) pass by pass in every kind of transform. This holds
the kernels' indexing, their barriers and their shared memory before a
card sees them; the card runs the same comparison in chip_smoke.py. Equality is exact."""

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
from zelana_tpu_torch.ops import field_kernels as FK
from zelana_tpu_torch.ops import limbs as L
from zelana_tpu_torch.ops import ntt as NTT

torch.set_num_threads(1)  # many small int64 ops: threads only contend

EMU = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda_emu")


def _emu_launches(src: str) -> tuple:
    """kernel<...><<<cfg>>>(args); -> emu_launch(cfg, [&] { kernel(args);
    }); the arguments end at the parenthesis that closes them, so a launch
    inside a macro argument (ZT_BY_FIELD) converts too."""
    out, pos, count = [], 0, 0
    for m in re.finditer(r"(\w+(?:<[^<>;]*>)?)\s*<<<([^>]*)>>>\s*\(", src):
        if m.start() < pos:
            continue
        depth, j = 1, m.end()
        while depth:
            depth += {"(": 1, ")": -1}.get(src[j], 0)
            j += 1
        out += [src[pos:m.start()], f"emu_launch({m.group(2)}, [&] {{ "
                f"{m.group(1)}({src[m.end():j - 1]}); }})"]
        pos, count = j, count + 1
    return "".join(out) + src[pos:], count


def _build(name: str, launches: int) -> ctypes.CDLL:
    """csrc/<name>.cu rewritten for the stand-in and built with g++."""
    out = os.path.join(cuda.BUILD, "emu")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(cuda.CSRC, "field.cuh")) as f:
        field = f.read()
    field, n = re.subn(r"namespace ptx \{.*\}  // namespace ptx",
                       "namespace ptx = emu_ptx;", field, flags=re.S)
    assert n == 1, "field.cuh: no ptx namespace to replace"
    with open(os.path.join(cuda.CSRC, f"{name}.cu")) as f:
        src = f.read()
    src, n = _emu_launches(src)
    assert n >= launches, f"{name}.cu: kernel launches not found"
    src = re.sub(r"extern __shared__ (\w+) (\w+)\[\];",
                 r"\1* \2 = (\1*)emu_dyn.data();", src)
    for fname, text in (("field.cuh", field), (f"{name}.cpp", src)):
        with open(os.path.join(out, fname), "w") as f:
            f.write(text)
    so = os.path.join(out, f"lib{name}_emu.so")
    tmp = f"{so}.tmp{os.getpid()}"
    subprocess.run(["g++", "-std=c++20", "-O2", "-shared", "-fPIC",
                    "-w", f"-I{EMU}", f"-I{out}", "-o", tmp,
                    os.path.join(out, f"{name}.cpp")], check=True)
    os.replace(tmp, so)
    cdll = ctypes.CDLL(so)
    cuda._declare(cdll)
    return cdll


@pytest.fixture(scope="module")
def lib():
    return _build("curve_kernels", 10)


@pytest.fixture(scope="module")
def flib():
    return _build("field_kernels", 7)


@pytest.fixture(scope="module")
def nlib():
    return _build("ntt_kernels", 1)


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


FIELDS = {"Fq": L.FQ, "Fr": L.FR, "BLS12-381 Fr": L.BLS_FR}


def _field_words(rng, spec: L.FieldSpec, n: int) -> torch.Tensor:
    """(8, n) words of random canonical elements (top word below the
    modulus's)."""
    w = rng.integers(0, 1 << 32, size=(8, n), dtype=np.uint64)
    w[7] %= spec.modulus >> 224
    return torch.from_numpy(w.astype(np.uint32).view(np.int32))


@pytest.mark.parametrize("field", list(FIELDS))
def test_emulated_inv_base_matches_plain(flib, field):
    """1,024 random elements and the edges 0, 1, 2, p - 1 and R mod p (n =
    1,029: a partial last warp) against the a^(p-2) ladder."""
    spec = FIELDS[field]
    rng = np.random.default_rng(91 + FK._field_id(spec))
    edges = [0, 1, 2, spec.modulus - 1, (1 << 256) % spec.modulus]
    a = torch.cat([_field_words(rng, spec, 1024),
                   L.to_tensor(L.to_words(edges), "cpu")], dim=1)
    got = torch.empty_like(a)
    assert flib.zt_inv_base(FK._field_id(spec), a.data_ptr(), got.data_ptr(),
                            a.shape[1], None) == 0
    assert torch.equal(got, FK.inv_base_plain(a, spec))


@pytest.mark.parametrize("field,n", [("Fr", (1 << 18) + 3072),
                                     ("Fq", 20480), ("Fr", 4096)])
def test_emulated_inv_bwd_matches_plain(flib, field, n):
    """2^18 + 3,072: two threads a chain behind the cp.async ring, 16 whole
    tiles and a partial one of three steps; 20,480 (a whole tile and a
    partial one of four) and 4,096 (one partial tile, four threads a
    chain): the suffix scan. Random words stand in for a, the prefixes and
    the totals' inverses: every output is a product of them."""
    spec = FIELDS[field]
    rng = np.random.default_rng(n)
    a, prefix = (_field_words(rng, spec, n) for _ in range(2))
    tinv = _field_words(rng, spec, FK.inv_chains(n))
    got = torch.empty_like(a)
    fid = FK._field_id(spec)
    assert flib.zt_inv_bwd(fid, a.data_ptr(), prefix.data_ptr(),
                           tinv.data_ptr(), got.data_ptr(), n, 0,
                           None) == 0
    assert torch.equal(got, FK.inv_bwd_plain(a, prefix, tinv, spec))
    # the 16-byte staging copies refuse a misaligned operand
    assert flib.zt_inv_bwd(fid, a.data_ptr() + 4, prefix.data_ptr(),
                           tinv.data_ptr(), got.data_ptr(), n, 0,
                           None) == 716


@pytest.mark.parametrize("n", [20480, 4096])
def test_emulated_inv_bwd_ring_below_threshold(flib, n):
    """Two threads a chain forced (mapping 1) at the short levels that the
    scan takes on the path, as chip_smoke.py times it there: a whole tile
    and a partial one of four steps; one partial tile of four."""
    spec = L.FR
    rng = np.random.default_rng(n + 1)
    a, prefix = (_field_words(rng, spec, n) for _ in range(2))
    tinv = _field_words(rng, spec, FK.inv_chains(n))
    got = torch.empty_like(a)
    assert flib.zt_inv_bwd(FK._field_id(spec), a.data_ptr(),
                           prefix.data_ptr(), tinv.data_ptr(),
                           got.data_ptr(), n, 1, None) == 0
    assert torch.equal(got, FK.inv_bwd_plain(a, prefix, tinv, spec))


def _fwd(flib, spec, a, mapping: int):
    """zt_inv_fwd on host memory -> (return code, prefix, totals)."""
    n = a.shape[1]
    prefix = torch.empty_like(a)
    totals = torch.empty((8, FK.inv_chains(n)), dtype=torch.int32)
    rc = flib.zt_inv_fwd(FK._field_id(spec), a.data_ptr(), prefix.data_ptr(),
                         totals.data_ptr(), n, mapping, None)
    return rc, prefix, totals


@pytest.mark.parametrize("mapping", [0, 1, 2])
@pytest.mark.parametrize("field,n", [("Fr", (1 << 18) + 3072),
                                     ("Fq", 20480), ("Fr", 4096)])
def test_emulated_inv_fwd_matches_plain(flib, field, n, mapping):
    """Mapping 0 (the launcher's pick: a thread a chain behind the cp.async
    ring at 2^18 + 3,072, 16 whole tiles and a partial one of three steps;
    the prefix scan at 20,480, a whole tile and a partial one of four, and
    at 4,096, one partial tile, four threads a chain), then each mapping
    forced at the same n. Prefixes and totals whole against the plain
    version."""
    spec = FIELDS[field]
    a = _field_words(np.random.default_rng(n + 2), spec, n)
    rc, prefix, totals = _fwd(flib, spec, a, mapping)
    assert rc == 0
    want = FK.inv_fwd_plain(a, spec)
    assert torch.equal(prefix, want[0]) and torch.equal(totals, want[1])
    # the 16-byte staging copies refuse a misaligned operand
    assert flib.zt_inv_fwd(FK._field_id(spec), a.data_ptr() + 4,
                           prefix.data_ptr(), totals.data_ptr(), n, mapping,
                           None) == 716


def _with_zeros(rng, spec, n: int) -> torch.Tensor:
    """Random words with zeros at the first and the last element, at 40
    random places and along the whole of chain 5 of tile 0."""
    a = _field_words(rng, spec, n)
    cols = [0, n - 1, *rng.choice(np.arange(1, n - 1), 40, replace=False)]
    a[:, cols] = 0
    a[:, 5:FK.INV_TILE:FK.INV_BLOCK] = 0
    return a


@pytest.mark.parametrize("kernel,mapping", [
    ("inv_fwd", 1), ("inv_fwd", 2), ("inv_bwd", 1), ("inv_bwd", 2)])
def test_emulated_zeros_match_plain(flib, kernel, mapping):
    """Inputs with zeros at 20,480 Fr elements (a whole tile and a partial
    one of four) in each thread mapping: a zero counts as one in the
    products, and inv_bwd writes zero in its place; bit-equal to the plain
    versions."""
    spec = L.FR
    n = 20480
    rng = np.random.default_rng(97 + mapping)
    a = _with_zeros(rng, spec, n)
    fid = FK._field_id(spec)
    if kernel == "inv_fwd":
        rc, prefix, totals = _fwd(flib, spec, a, mapping)
        assert rc == 0
        want = FK.inv_fwd_plain(a, spec)
        assert torch.equal(prefix, want[0]) and torch.equal(totals, want[1])
        return
    prefix = _field_words(rng, spec, n)
    tinv = _field_words(rng, spec, FK.inv_chains(n))
    got = torch.empty_like(a)
    assert flib.zt_inv_bwd(fid, a.data_ptr(), prefix.data_ptr(),
                           tinv.data_ptr(), got.data_ptr(), n, mapping,
                           None) == 0
    want = FK.inv_bwd_plain(a, prefix, tinv, spec)
    assert torch.equal(got, want)
    assert not want[:, (a == 0).all(dim=0)].any()


@pytest.mark.parametrize("log_n,split", [
    (10, [10]), (10, [5, 5]), (10, [4, 3, 3]), (10, [1, 9]), (11, [11]),
    (11, None), (12, None), (13, None), (13, [7, 6]), (13, [3, 10])])
def test_emulated_ntt_passes_match_plain(nlib, monkeypatch, log_n, split):
    """Every kind of transform (no prologue or epilogue; 1/n; g^j; 1/n
    g^-j; the quotient (a b - c) / Z with 1/n g^-j) through the emulated
    pass kernel, each pass against ntt_pass_plain on the same input: the
    card's own split (None) at 2^11 to 2^13, and forced splits from a pass
    of one stage to one of all 11 at 2^11 (64 KB of dynamic shared
    memory; ten at 2^13 with the spread bits cut to fit a tile). The first pass leaves
    its inputs unchanged; later passes run in place."""
    n = 1 << log_n
    plan = NTT.make_plan(n)
    rng = np.random.default_rng(log_n + 100 * len(split or []))
    xs = [_field_words(rng, L.FR, n) for _ in range(3)]
    plain = NTT.ntt_pass_plain
    launched = []

    def emulated(ins, twst, s0, s1, pro=0, ptab=None, pk=None, epi=0,
                 etab=None, ek=None):
        before = [t.clone() for t in ins]
        want = plain(ins, twst, s0, s1, pro, ptab, pk, epi, etab, ek)
        out = torch.empty_like(ins[0]) if s0 == 0 else ins[0]
        ptr = [t.data_ptr() for t in ins] + [None] * (3 - len(ins))
        assert nlib.zt_ntt_pass(
            *ptr, out.data_ptr(), twst.data_ptr(),
            None if ptab is None else ptab.data_ptr(),
            None if etab is None else etab.data_ptr(),
            NTT._host_words(pk), NTT._host_words(ek), n, s0, s1, pro, epi,
            None) == 0
        assert torch.equal(out, want), (s0, s1, pro, epi)
        if s0 == 0:
            assert all(torch.equal(t, b) for t, b in zip(ins, before))
        launched.append((s0, s1))
        return out

    monkeypatch.setattr(NTT, "ntt_pass_plain", emulated)
    split = split or NTT.default_split(log_n)
    for kind in NTT.KINDS:
        ins = xs if kind == "quotient" else xs[:1]
        NTT.transform_split(kind, ins, plan, split)
    assert len(launched) == len(NTT.KINDS) * len(split)


def test_emulated_ntt_pass_refusals(nlib):
    """The launcher refuses what the kernel does not take: n not a power
    of two, stages past log n, more stages than a tile holds, a prologue
    off the first pass or an epilogue off the last, a missing table."""
    n = 1 << 10
    x = _field_words(np.random.default_rng(3), L.FR, n)
    out = torch.empty_like(x)
    p = x.data_ptr()

    def rc(n=n, s0=0, s1=10, pro=0, epi=0, ptab=p, etab=p):
        return nlib.zt_ntt_pass(p, p, p, out.data_ptr(), p, ptab, etab,
                                NTT._host_words(np.ones(8)),
                                NTT._host_words(np.ones(8)), n, s0, s1, pro,
                                epi, None)

    assert rc() == 0
    assert rc(n=n - 1) == 1
    assert rc(s1=11) == 1
    assert rc(n=1 << 13, s0=0, s1=12) == 1
    assert rc(s0=5, s1=10, pro=1) == 1
    assert rc(s0=0, s1=5, epi=1) == 1
    assert rc(pro=1, ptab=None) == 1
    assert rc(epi=2, etab=None) == 1
