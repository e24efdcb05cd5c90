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
cp.async ring; a suffix scan), both on inputs with zeros, the Poseidon
kernel in its permute and sponge modes over the three configurations, and
the NTT pass kernel (ntt_kernels.cu) pass by pass in every kind of transform, the
sharded NTT's cross-rank stage (ntt_cross_kernel), and the Jacobian MSM's
kernels (jac_kernels.cu: the batch add on every case of point_add's mask
dispatch, a scan step, the bucket reduction and Horner, the doubling and
identity branches among them). This holds
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
from zelana_tpu_torch.hashes import poseidon as TP
from zelana_tpu_torch.hashes import poseidon_batch as PB
from zelana_tpu_torch.ops import curve_kernels as CK
from zelana_tpu_torch.ops import curve_ops as CO
from zelana_tpu_torch.ops import cuda
from zelana_tpu_torch.ops import field_kernels as FK
from zelana_tpu_torch.ops import limbs as L
from zelana_tpu_torch.ops import msm as M
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
    return _build("ntt_kernels", 2)


@pytest.fixture(scope="module")
def jlib():
    return _build("jac_kernels", 4)


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


@pytest.mark.parametrize("curve,nb", [
    ("g1", 8192), ("g1", 4096), ("g1", 2048),
    ("g2", 8192), ("g2", 4096), ("g2", 2048)])
def test_emulated_merge_pairs_matches_plain(lib, curve, nb):
    """bucket_merge with K = 2 over [a | b], as merge_pairs calls it, at the
    sharded MSM's widths: 8,192 (a shard's segments added up), 4,096 and
    2,048 (the reduce-scatter's adds over four ranks), against
    bucket_merge_plain."""
    rng = np.random.default_rng(91 + nb.bit_length() + 8 * (curve == "g2"))
    C = CK.rows(curve)
    ab = _rand_words(rng, C, 2 * nb)
    dense = torch.arange(2 * nb, dtype=torch.int32)
    merged = torch.empty((C, nb), dtype=torch.int32)
    assert lib.zt_bucket_merge(0 if curve == "g1" else 1, ab.data_ptr(),
                               2 * nb, dense.data_ptr(), 2, nb,
                               merged.data_ptr(), None) == 0
    assert torch.equal(merged, CK.bucket_merge_plain(ab, dense, 2, curve, nb))


def _neg(words: torch.Tensor, curve: str) -> torch.Tensor:
    return CO.join(CO.point_neg(CO.ops(curve), CO.split(words, curve)), curve)


def _scan_case(rng, curve: str, offset: int):
    """A scan step's operands: two windows of 150 lanes (300 lanes, a
    partial last block of 32), digits drawn skewed (a run of about 120 lanes
    crossing block boundaries) and sorted as the MSM sorts them, the run
    positions of ops/msm.py scan_plan (digit 0's lanes at -1); general random words with point_add's
    mask cases seeded into lane pairs (i, i - offset) of a run; dst holds
    src where pos < offset // 2 (final lanes, not written) and junk
    elsewhere."""
    C, w, n = CK.rows(curve), 2, 150
    keys = np.sort(rng.choice(4, size=(w, n), p=[0.05, 0.8, 0.1, 0.05]),
                   axis=1)
    pos = torch.from_numpy(M.scan_plan(keys)[0])
    src = _rand_words(rng, C, w * n)
    flat = pos.reshape(-1)
    used, pairs = set(), []
    for i in range(w * n):
        if flat[i] >= offset and not {i, i - offset} & used:
            used |= {i, i - offset}
            pairs.append(i)
    k = len(pairs)
    p, q = CO.seed_mask_cases(_rand_words(rng, C, k), _rand_words(rng, C, k),
                              _rand_words(rng, C, k)[:C // 3], curve)
    idx = torch.tensor(pairs)
    src[:, idx], src[:, idx - offset] = p, q
    src = src.view(C, w, n)
    junk = _rand_words(rng, C, w * n).view(C, w, n)
    dst = torch.where((pos < offset // 2)[None], src, junk)
    return src, dst, pos


def _reduce_case(rng, curve: str):
    """Two windows of 300 lanes and their (2, 256) run-end table. Window 0:
    buckets 255, 253, 251 random, bucket 250 the running sum so far (the
    doubling branch), 248 its negation (the identity), then every fourth
    bucket random; window 1: only bucket 255, so total + running doubles at
    d = 254 and every later add meets an identity."""
    C, w, n = CK.rows(curve), 2, 300
    vals = _rand_words(rng, C, w * n)
    ends = torch.full((w, 256), -1, dtype=torch.int32)
    lanes = iter(rng.permutation(w * n // 2).tolist())
    running = CO.ident_words(curve, 1, "cpu")
    for d in range(255, 0, -1):
        if d in (255, 253, 251) or (d < 248 and d % 4 == 0):
            s = _rand_words(rng, C, 1)
        elif d == 250:
            s = running
        elif d == 248:
            s = _neg(running, curve)
        else:
            continue
        ends[0, d] = next(lanes)
        vals[:, ends[0, d]] = s[:, 0]
        if d >= 248:
            running = CO.jac_add_plain(running, s, curve)
    ends[1, 255] = n + next(lanes)
    return vals.view(C, w, n), ends


def _horner_case(rng, curve: str) -> torch.Tensor:
    """32 window totals, random words with identities among them (windows
    3, 17 and 0), T[30] = 2^8 T[31] (the add's doubling branch) and T[29]
    = -2^8 acc (the identity)."""
    C = CK.rows(curve)
    tot = _rand_words(rng, C, 32)
    ident = CO.ident_words(curve, 1, "cpu")[:, 0]
    for w in (3, 17, 0):
        tot[:, w] = ident
    tot[:, 30] = CO.jac_double_plain(tot[:, 31:], curve, 8)[:, 0]
    acc = CO.jac_double_plain(tot[:, 31:], curve, 8, tot[:, 30:31])
    tot[:, 29] = _neg(CO.jac_double_plain(acc, curve, 8), curve)[:, 0]
    return tot


@pytest.mark.parametrize("curve,form", [
    (c, f) for c in ("g1", "g2")
    for f in ("add", "scan 1", "scan 64", "reduce", "horner")])
def test_emulated_jac_kernels_match_plain(jlib, curve, form):
    """The Jacobian MSM's kernels (jac_kernels.cu) against their plain
    versions: the batch add over 136 points with point_add's eight mask
    cases (curve_ops.MASK_CASES) seeded in, 17 each, a partial second
    block, p read through a row stride wider than its columns; a scan step
    at offsets 1 and 64 (_scan_case), and the lanes it leaves unwritten the
    same as the CPU wrapper's; the bucket reduction over two windows
    (_reduce_case); Horner over 32 totals (_horner_case)."""
    rng = np.random.default_rng(
        [101, int(curve == "g2"), ["add", "scan 1", "scan 64", "reduce",
                              "horner"].index(form)])
    C, cid = CK.rows(curve), 0 if curve == "g1" else 1
    if form == "add":
        n = 136
        p, q = CO.seed_mask_cases(_rand_words(rng, C, n),
                                  _rand_words(rng, C, n),
                                  _rand_words(rng, C, n)[:C // 3], curve)
        wide = torch.zeros((C, n + 40), dtype=torch.int32)
        wide[:, :n] = p
        got = torch.empty((C, n), dtype=torch.int32)
        assert jlib.zt_jac_add(cid, wide.data_ptr(), n + 40, q.data_ptr(), n,
                               got.data_ptr(), n, None) == 0
        want = CO.jac_add_plain(p, q, curve)
    elif form.startswith("scan"):
        offset = int(form.split()[1])
        src, got, pos = _scan_case(rng, curve, offset)
        assert jlib.zt_jac_scan(cid, src.data_ptr(), got.data_ptr(),
                                pos.data_ptr(), pos.numel(), offset,
                                None) == 0
        want = CO.jac_scan_step_plain(src, pos, offset, curve)
        assert (pos >= offset).sum() > 60  # lanes that add
        assert (pos < 0).sum() > 0  # digit 0's lanes
        # the lanes left unwritten are the same ones on either device
        junk = _rand_words(rng, C, pos.numel()).view_as(src)
        emu, cpu = junk.clone(), junk.clone()
        assert jlib.zt_jac_scan(cid, src.data_ptr(), emu.data_ptr(),
                                pos.data_ptr(), pos.numel(), offset,
                                None) == 0
        assert torch.equal(emu, CO.jac_scan_step(src, cpu, pos, offset,
                                                 curve))
    elif form == "reduce":
        vals, ends = _reduce_case(rng, curve)
        got = torch.zeros((C, 3), dtype=torch.int32)  # windows in columns 1, 2
        assert jlib.zt_jac_reduce(cid, vals.data_ptr(), vals[0].numel(),
                                  ends.data_ptr(), 2, got[:, 1:].data_ptr(),
                                  3, None) == 0
        got = got[:, 1:]
        want = CO.jac_bucket_reduce_plain(vals, ends, curve)
    else:
        tot = _horner_case(rng, curve)
        wide = torch.zeros((C, 40), dtype=torch.int32)
        wide[:, :32] = tot
        got = torch.empty((C, 1), dtype=torch.int32)
        assert jlib.zt_jac_horner(cid, wide.data_ptr(), 40, 32,
                                  got.data_ptr(), None) == 0
        want = CO.jac_horner_plain(tot, curve)
    assert torch.equal(got, want)


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


POSEIDON = {"bn254_8_56": TP.bn254_config, "bn254_8_57": TP.bn254_config_57,
            "bls12_381_8_57": TP.bls12_381_config}


def _poseidon(flib, cfg, cols, state, n: int):
    """zt_poseidon on host memory -> (return code, out)."""
    spec = L.FieldSpec(cfg.modulus)
    consts = PB._device_tables(cfg, torch.device("cpu"))
    out = torch.empty((3, 8, n) if state is not None else (8, n),
                      dtype=torch.int32)
    ptrs = (ctypes.c_void_p * max(len(cols), 1))(
        *[c.data_ptr() for c in cols])
    rc = flib.zt_poseidon(FK._field_id(spec), ptrs, len(cols),
                          None if state is None else state.data_ptr(),
                          out.data_ptr(), n, consts.data_ptr(),
                          cfg.full_rounds // 2, cfg.partial_rounds, None)
    return rc, out, consts


@pytest.mark.parametrize("k", [0, 2, 5])
@pytest.mark.parametrize("name", list(POSEIDON))
def test_emulated_poseidon_matches_plain(flib, name, k):
    """poseidon_kernel at n = 150 (a whole block of 128 threads and a
    partial one) against the plain versions: k = 0 permutes a (3, 8, n)
    state, k = 2 hashes two columns (the path's), k = 5 five (three
    permutations, the last after one column). The inputs hold 0, 1 and
    p - 1; every output word compared."""
    cfg = POSEIDON[name]()
    spec = L.FieldSpec(cfg.modulus)
    n = 150
    rng = np.random.default_rng(131 + 8 * k + len(name))
    edges = L.to_tensor(L.to_words([0, 1, spec.modulus - 1]), "cpu")
    words = [_field_words(rng, spec, n) for _ in range(max(k, 3))]
    for w in words:
        w[:, :3] = edges
    if k == 0:
        state = torch.stack(words).contiguous()
        rc, got, consts = _poseidon(flib, cfg, [], state, n)
        want = FK.poseidon_permute_plain(state, consts, cfg.full_rounds,
                                         cfg.partial_rounds, spec)
    else:
        rc, got, consts = _poseidon(flib, cfg, words[:k], None, n)
        want = FK.poseidon_sponge_plain(words[:k], consts, cfg.full_rounds,
                                        cfg.partial_rounds, spec)
    assert rc == 0
    assert torch.equal(got, want)


def test_emulated_poseidon_refusals(flib):
    """More columns than the kernel's 16, a negative column count and a
    negative round count are refused (cudaErrorInvalidValue) before a
    launch; an empty batch launches nothing and succeeds."""
    cfg = TP.bn254_config()
    cols = [_field_words(np.random.default_rng(7), L.FR, 70)]
    assert _poseidon(flib, cfg, cols * 17, None, 70)[0] == 1
    consts = PB._device_tables(cfg, torch.device("cpu"))
    out = torch.empty((8, 70), dtype=torch.int32)
    ptrs = (ctypes.c_void_p * 1)(cols[0].data_ptr())
    for k, half in ((-1, 4), (1, -1)):
        assert flib.zt_poseidon(FK._field_id(L.FR), ptrs, k, None,
                                out.data_ptr(), 70, consts.data_ptr(), half,
                                cfg.partial_rounds, None) == 1
    assert _poseidon(flib, cfg, cols, None, 0)[0] == 0


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
    (11, None), (12, None), (13, None), (13, [7, 6]), (13, [3, 10]),
    (15, None)])
def test_emulated_ntt_passes_match_plain(nlib, monkeypatch, log_n, split):
    """Every kind of transform (no prologue or epilogue; 1/n; g^j; 1/n
    g^-j; the quotient (a b - c) / Z with 1/n g^-j) through the emulated
    pass kernel, each pass against ntt_pass_plain on the same input: the
    card's own split (None) at 2^11 to 2^13 and at the shielded
    circuit's 2^15 ([5, 5, 5]), and forced splits from a pass
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


def _emulated_cross(nlib, own, recv, twst, col0, bit, ek=None):
    out = torch.empty_like(own)
    assert nlib.zt_ntt_cross(own.data_ptr(), recv.data_ptr(), twst.data_ptr(),
                             twst.shape[1], col0, out.data_ptr(),
                             own.shape[1], bit, NTT._host_words(ek),
                             None) == 0
    return out


@pytest.mark.parametrize("world,k,last", [
    (2, 0, False), (2, 0, True), (4, 0, False), (4, 1, False), (4, 1, True)])
def test_emulated_ntt_cross_matches_plain(nlib, world, k, last):
    """ntt_cross_kernel against ntt_cross_plain on every rank of cross
    stage k of a 2^11 transform over `world` ranks: both halves of the
    butterfly, the twiddle slice at (rank mod 2^k) m (nonzero only from
    k = 1), and with `last` the inverse's last stage with its 1/n."""
    n = 1 << 11
    m = n // world
    plan = NTT.make_plan(n)
    twst = plan.on("cpu")["twi_st" if last else "tw_st"]
    rng = np.random.default_rng(world * 10 + k)
    own, recv = (_field_words(rng, L.FR, m) for _ in range(2))
    ek = plan.n_inv if last else None
    for d in range(world):
        col0 = NTT.cross_twiddle_column(m, k, d)
        bit = (d >> k) & 1
        want = NTT.ntt_cross_plain(own, recv, twst, col0, bit, ek)
        assert torch.equal(_emulated_cross(nlib, own, recv, twst, col0, bit,
                                           ek), want), d


@pytest.mark.parametrize("world", [2, 4])
def test_emulated_sharded_ntt_matches_ntt(nlib, world):
    """Every rank of a sharded 2^10 NTT and iNTT simulated in one process:
    block_stages, then the cross stages through the emulated kernel, the
    blocks joined in rank order equal to the one-device transforms."""
    n = 1 << 10
    m = n // world
    plan = NTT.make_plan(n)
    x = _field_words(np.random.default_rng(world), L.FR, n)
    for inverse, want in ((False, NTT.ntt(x, plan)),
                          (True, NTT.intt(x, plan))):
        twst = plan.on("cpu")["twi_st" if inverse else "tw_st"]
        blocks = [NTT.block_stages(x, plan, world, d, inverse)
                  for d in range(world)]
        log_d = world.bit_length() - 1
        for k in range(log_d):
            ek = plan.n_inv if inverse and k == log_d - 1 else None
            blocks = [_emulated_cross(nlib, blocks[d], blocks[d ^ (1 << k)],
                                      twst, NTT.cross_twiddle_column(m, k, d),
                                      (d >> k) & 1, ek)
                      for d in range(world)]
        assert torch.equal(torch.cat(blocks, dim=1), want), inverse


def test_emulated_ntt_cross_refusals(nlib):
    """The launcher refuses a twiddle slice past the table's end, a bit
    that is not 0 or 1, and an empty block."""
    x = _field_words(np.random.default_rng(5), L.FR, 64)
    out = torch.empty_like(x)
    p = x.data_ptr()

    def rc(tw_ld=128, col0=64, m=64, bit=0):
        return nlib.zt_ntt_cross(p, p, p, tw_ld, col0, out.data_ptr(), m,
                                 bit, None, None)

    assert rc() == 0
    assert rc(col0=65) == 1
    assert rc(bit=2) == 1
    assert rc(m=0) == 1
