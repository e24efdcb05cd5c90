#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port of zelana-tpu on one card.

    python3 chip_smoke.py        # from the root of a checkout, one CUDA card
    python3 chip_smoke.py --phases kernels,keygen   # a subset, no result

Phases (any failure exits non-zero and prints no result):
  1. environment: card name and power limit, CUDA and nvcc versions, and the
     build of the kernels from zelana_tpu_torch/csrc (one nvcc per
     source, in parallel), with ptxas register and spill counts;
  2. `kernels`: each kernel against its plain PyTorch version on the card,
     exact equality: mont_mul (2^16 Fr, Fq and BLS12-381 Fr, with 0, 1 and
     p - 1, and at the shapes Poseidon's rounds give it: 1, 3 and 9 times
     2^15 lanes of BN254 Fr, 2^12 of BN254 and BLS12-381 Fr); ntt_pass,
     the NTT's pass kernel, in the five kinds of transform (ntt, intt,
     coset_ntt, coset_intt, the witness map's
     quotient) at 2^13 and 2^21 by the launcher's split and by every
     forced split of SPLITS_2_13 / SPLITS_2_21, each timed beside its
     bound, the L2 witness map (2^13) as a whole and a one-element fill
     (the floor of a launch); runscan in its four
     variants on a real schedule over a 2^12-point pool and bucket_tail
     (G1, G2) on that schedule's level-2 emit, step (G1, G2, general and
     mixed) at S = 2^14 by slot ids and by pairing in one round and in
     five, and keygen's five step rounds in one launch on a 32,768-scalar chunk
     (G1, G2) against five single plain rounds; mimc_permute at 2^14 (91
     rounds, and 3 rounds of the JAX test's constants); inv_fwd and
     inv_bwd at the levels of a 2^20 inversion (2^20, 2^16, 4,096) and at
     20,480 and 19,456 (partial last tiles), both Fr and Fq, and on inputs
     with zeros at 2^20 and 20,480, inv_base over Fr, Fq and BLS12-381 Fr
     at 1,024 and 2^16 elements with 0, 1, 2, p - 1 and R mod p, whole
     outputs compared; inv_fwd and inv_bwd timed per level and in both
     thread mappings, forced, from 4,096 to 2^20, inv_base at 1,024 Fr and
     on one warp;
  `hashes`: hash2_batch at 2^20 leaves (one level of a 2^21-leaf account
     tree), hash_n_batch with 3 and 5 columns at 2^16, Poseidon BN254 8/56
     over two columns at 2^15 and BN254 8/57 / BLS12-381 8/57 at 2^12; 256
     sampled outputs of each equal to the host hashes; launches and times;
  `inversion`: mont_batch_inv_nested over Fr at 2^20 and 20,480 and over
     Fq at 2^20 with seeded zeros, and over Fr on the copy path (a ragged
     20,403, a column slice and a misaligned contiguous view at 20,480):
     the whole output equal to the plain version on the card and a * inv == 1 (0 at the zeros) by the mont_mul
     kernel; launches per call (3 inv_fwd, 3 inv_bwd, 1 inv_base at 2^20)
     and times; ten 2^20 Fr inversions under torch.profiler, device time
     by kernel, no device kernel but the port's inversion kernels allowed;
  3. `slice`: prove and prove_many over the L2 block circuit with
     artifacts/l2_dummy_pk.npz, every proof checked by verify, the
     batch_id = 1 proof byte-equal to the vector the JAX package recorded;
     launch counts of the prover's kernels on this run (21 ntt_pass a
     proof, 7 transforms of 3 passes, and no mont_mul, asserted); one more
     prove under torch.profiler gives the device's idle share;
  4. `keygen`: keygen of the L2 dummy circuit and Groth16ChunkProver.setup
     of the (1,0,1) depth-1 chunk, each equal array for array to the JAX
     package's seed-0 key in artifacts/; the dryrun chunk's proof equal to
     zelana_tpu_torch/testdata/chunk_101_d1_proof.json, and
     prove_synthesized equal to the DSL prove on that chunk;
  5. `chunk`: the witness map at 2^21 against its plain version on the
     card, its inputs unchanged, three calls under torch.profiler (no
     device kernel but ntt_pass_kernel allowed, 21 launches a call), and
     G1 / G2 MSMs at chunk size against their closed form (pools
     of synthetic points); on one full 2^16-point segment of each curve the
     lane sweep (the whole segment's device time per level-1 lane count and
     level-2 cap), the kernel times at the earlier shapes (8,192 / 2,048
     lanes, 1,024 level-2 lanes) and at the chosen ones beside their bound,
     and the chosen level-1 pass and bucket tail against their plain
     versions on the card;
  6. `production`: Groth16ChunkProver.setup((8, 4, 4), 32) makes the
     production key (1,129,391 variables, 2^21 domain) with the step
     kernel (one launch per chunk and curve), then prove_chunks proves a
     batch that fills two chunks; both proofs pass verify_chunk and their
     roots chain. Phase times of keygen, per-chunk prove times and launches,
     the run-scan and bucket-tail device time, busy time and idle share of
     one chunk prove under torch.profiler with the torch copy and gather
     kernels left on its device, the peak device memory, and R, R2 and K2
     of the chunk's z schedules;
  7. one JSON line of per-kernel numbers (launches: the prover's kernels
     on the L2 slice, step on the production keygen, mimc_permute and
     mont_mul (Poseidon's rounds) on the hashes, inv_fwd / inv_bwd /
     inv_base on the inversions), the card, the result line.

Imports nothing of JAX or of the JAX package.
"""

import argparse
import contextlib
import functools
import itertools
import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
# 32-bit integer multiply(-add) issue rate: 132 SMs x 64 INT32 lanes x
# 1.98 GHz boost (Hopper SM layout); the data sheet gives no int32 rate
INT32_OPS_PER_S = 132 * 64 * 1.98e9
MUL_OPS = 2 * 2 * 8 * 8 + 8  # one 8x32-bit CIOS: 128 wide products, 8 m's

CHUNK_CONSTRAINTS = 1_128_532  # the 8/4/4 production chunk
CHUNK_DOMAIN = 1 << 21
PRODUCTION = ((8, 4, 4), 32)  # capacity and tree depth of the chunk
PHASES = ("kernels", "hashes", "inversion", "slice", "keygen", "chunk",
          "production")
SLICE_KERNELS = ("ntt_pass", "runscan", "bucket_tail", "mont_mul")


def log(*a):
    print(*a, flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES)
                    + "; a subset prints no result line")
    phases = ap.parse_args().phases.split(",")
    if set(phases) - set(PHASES):
        ap.error(f"unknown phase in {phases}")
    import torch

    t_start = time.time()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "zelana_tpu_torch")):
        print("chip_smoke: zelana_tpu_torch not found beside the script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    os.chdir(root)

    from zelana_tpu_torch.ops import cuda

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    nvcc_v = subprocess.run([cuda._nvcc(), "--version"], capture_output=True,
                            text=True, check=True).stdout.strip()
    log("nvcc:", nvcc_v.splitlines()[-1])
    t0 = time.time()
    build = cuda.build_all()
    log(f"kernel build: {time.time() - t0:.1f} s wall "
        + ", ".join(f"{k} {v['seconds']:.1f} s" for k, v in build.items()))
    for name, info in build.items():
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"  ptxas {name}: {line.strip()}")

    report = {}
    kernels, launches = [], {}
    if "kernels" in phases:
        kernels = phase_kernels(torch, dev, report)
    if "hashes" in phases:
        launches.update(phase_hashes(torch, dev, report))
    if "inversion" in phases:
        launches.update(phase_inversion(torch, dev, report))
    if "slice" in phases:
        launches.update(phase_slice(torch, dev, report))
    if "keygen" in phases:
        phase_keygen(report)
    if "chunk" in phases:
        phase_chunk(torch, dev, report)
    if "production" in phases:
        # step's launches come from the production keygen
        launches["step"] = phase_production(torch, report)["step"]
    wall = time.time() - t_start
    report["wall_s"] = wall
    log(f"chip_smoke wall time: {wall:.1f} s")
    log(json.dumps({"card": card, "report": report}))
    if phases != list(PHASES):
        log(f"partial run ({','.join(phases)}): no result line")
        return 0

    out = []
    for k in kernels:
        k["launches"] = launches[k["name"]]
        if k["launches"] == 0:
            raise AssertionError(f"{k['name']} never launched on the path")
        out.append(k)
    log(card)
    log(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def cuda_ms(torch, fn, reps: int = 5, warm: bool = True) -> float:
    """Mean device time of fn over `reps` runs, after one warm-up run."""
    if warm:
        fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / reps


@contextlib.contextmanager
def profiled(torch):
    """torch.profiler over the host and the card; the card is synchronized
    before the window closes."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield prof
        torch.cuda.synchronize()


def device_profile(torch, fn, reps: int = 20, kernels: int = 0,
                   tries: int = 3):
    """(device time a run, device kernels a run, the device events) of fn,
    from torch.profiler's device events over `reps` runs after a warm-up.
    CUDA events around back-to-back runs measure the host's launch rate
    instead when a kernel runs shorter than its wrapper's launch takes.
    Now and then the profiler returns a window short of its device events
    (late in a long process: 6 of 20 one-kernel calls missing, or all of
    them). One rule for that: up to `tries` windows are profiled; a window
    that holds reps x `kernels` device kernels (the kernels a run launches,
    or at least launches, where the caller knows them) ends the search;
    the window with the most kernels counts, read per run over the runs
    its kernels cover (over `reps` where `kernels` is 0, and then every
    try is made), and a short one is logged. Where every window is empty,
    the time is spin_ms's, the kernels a run None and the events empty."""
    best, most = [], -1
    for _ in range(tries):
        fn()
        torch.cuda.synchronize()
        with profiled(torch) as prof:
            for _ in range(reps):
                fn()
        events = device_events(prof, empty_ok=True)
        seen = sum(e.count for e in events)
        if seen > most:
            best, most = events, seen
        if kernels and seen >= reps * kernels:
            break
    if not best:
        ms = spin_ms(torch, fn, reps)
        log(f"  {tries} profiles held no device events: {ms:.5f} ms a run "
            f"by CUDA events behind a spin kernel (spin_ms)")
        return ms, None, []
    runs = min(reps, most / kernels) if kernels else reps
    if runs < reps:
        log(f"  the fullest of {tries} profiles held {most} device kernels "
            f"of {reps * kernels}: read over the {runs:.2f} runs they cover")
    return (sum(e.self_device_time_total for e in best) / 1e3 / runs,
            most / runs, best)


def spin_ms(torch, fn, reps: int = 20) -> float:
    """Mean time of fn over `reps` back-to-back runs by CUDA events that
    the host queues behind a spin kernel long enough to cover its launches,
    so that the card runs them without the host's gaps: a little above the
    profiler's device time (tools/profile_windows.py sets them side by
    side)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2 * reps * host_s, 1.0) * 2e9))  # ~2 GHz
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / reps


def device_ms(torch, fn, reps: int = 20, kernels: int = 0) -> float:
    """device_profile's device time a run."""
    return device_profile(torch, fn, reps, kernels)[0]


def rotating(fn, inputs):
    """A call of fn on each tuple of `inputs` in turn: copies of the inputs
    that together exceed the 50 MB L2 make each launch read its own from
    HBM."""
    it = itertools.cycle(inputs)
    return lambda: fn(*next(it))


def compare(torch, got, want):
    """(mismatched columns, max |word difference|) of two word tensors."""
    g = got.to(torch.int64) & 0xFFFFFFFF
    w = want.to(torch.int64) & 0xFFFFFFFF
    diff = (g - w).abs()
    cols = diff.reshape(diff.shape[0], -1).amax(dim=0)
    return int((cols != 0).sum()), int(diff.max())


def bound_ms(nbytes: float, ops: float):
    tb, to = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


RUNSCAN_MULS = {("g1", False): 11, ("g1", True): 12, ("g2", False): 39,
                ("g2", True): 42}  # Montgomery products per stream add


def runscan_work(torch, pool, ids, flags, curve, proj_in):
    """(bytes, int32 operations) of one run-scan: the pool columns the ids
    name, read once, the ids and flags, the emit written; one stream add
    per row without a flag."""
    C = 24 if curve == "g1" else 48
    uniq = int(torch.unique(ids).numel())
    nbytes = 4 * (pool.shape[0] * uniq + 2 * flags.numel() + C * flags.numel())
    adds = int((flags == 0).sum())
    return nbytes, adds * RUNSCAN_MULS[(curve, proj_in)] * MUL_OPS


def tail_work(torch, emit2, dense, K, curve):
    """(bytes, int32 operations) of one bucket tail: the emit columns the
    dense ids name, read once, the ids, the 256 finals written; (K - 1)
    merge adds per bucket and 127 tree adds per subset group."""
    C = 24 if curve == "g1" else 48
    uniq = int(torch.unique(dense).numel())
    nbytes = 4 * (C * uniq + dense.numel() + C * 256)
    adds = (K - 1) * 8192 + 256 * 127
    return nbytes, adds * RUNSCAN_MULS[(curve, True)] * MUL_OPS


def rand_words(torch, rng, modulus_top: int, n: int, dev):
    """(8, n) int32 words of random canonical values (top word below the
    modulus's top word, so every value is < p)."""
    import numpy as np

    w = rng.integers(0, 1 << 32, size=(8, n), dtype=np.uint64)
    w[7] %= modulus_top
    return torch.from_numpy(w.astype(np.uint32).view(np.int32)).to(dev)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def phase_kernels(torch, dev, report) -> list:
    import numpy as np

    from zelana_tpu_torch.curves import g1 as G1, g2 as G2
    from zelana_tpu_torch.fields.bn254 import R as FR
    from zelana_tpu_torch.hashes import poseidon as P
    from zelana_tpu_torch.ops import curve_kernels as CK
    from zelana_tpu_torch.ops import field_kernels as FK
    from zelana_tpu_torch.ops import limbs as L
    from zelana_tpu_torch.ops import msm_scan as MSM

    rng = np.random.default_rng(2024)
    kernels = []
    mismatches = {}  # kernel -> mismatched columns over all its checks

    def check(name, got, want):
        mism, err = compare(torch, got, want)
        log(f"  {name}: mismatches {mism}, max |diff| {err}")
        kernel = name.split()[0]
        mismatches[kernel] = mismatches.get(kernel, 0) + mism
        return err

    # mont_mul at 2^16, Fr and Fq, with 0, 1 and p - 1 among the inputs
    n = 1 << 16
    err = 0
    ms = plain = 0.0
    for spec in (L.FR, L.FQ):
        a = rand_words(torch, rng, spec.modulus >> 224, n, dev)
        b = rand_words(torch, rng, spec.modulus >> 224, n, dev)
        edge = L.to_tensor(L.to_words([0, 1, spec.modulus - 1]), dev)
        a[:, :3] = edge
        b[:, 3:6] = edge
        b[:, 6:9] = edge
        a[:, 6:9] = edge
        err = max(err, check(f"mont_mul {'Fr' if spec is L.FR else 'Fq'}",
                             FK.mont_mul(a, b, spec),
                             FK.mont_mul_plain(a, b, spec)))
        ms += cuda_ms(torch, lambda: FK.mont_mul(a, b, spec), 20)
        plain += cuda_ms(torch, lambda: FK.mont_mul_plain(a, b, spec), 1,
                         False)
    # BLS12-381 Fr (the privacy SDK's Poseidon field): checked, timed apart
    spec = L.BLS_FR
    a = rand_words(torch, rng, spec.modulus >> 224, n, dev)
    b = rand_words(torch, rng, spec.modulus >> 224, n, dev)
    edge = L.to_tensor(L.to_words([0, 1, spec.modulus - 1]), dev)
    a[:, :3] = b[:, 3:6] = b[:, 6:9] = a[:, 6:9] = edge
    err = max(err, check("mont_mul BLS12-381 Fr", FK.mont_mul(a, b, spec),
                         FK.mont_mul_plain(a, b, spec)))
    bls_ms = cuda_ms(torch, lambda: FK.mont_mul(a, b, spec), 20)
    bls_bound = bound_ms(n * 96, n * MUL_OPS)
    log(f"  mont_mul BLS12-381 Fr 2^16: {bls_ms:.4f} ms, bound "
        f"{bls_bound[0]:.4f} ms ({bls_bound[1]})")
    report["mont_mul_bls12_381_2_16"] = {"ms": bls_ms,
                                         "bound_ms": bls_bound[0]}
    # the shapes Poseidon's rounds give it on the hashes path, where its
    # launches are counted: (8, lanes) for a partial round's s-box,
    # (8, 3 lanes) for a full round's, (8, 9 lanes) for the MDS products;
    # 2^15 lanes of BN254 8/56, 2^12 of BN254 8/57 and BLS12-381 8/57
    for name, cfg, lanes in (("BN254 8/56", P.bn254_config(), 1 << 15),
                             ("BN254 8/57", P.bn254_config_57(), 1 << 12),
                             ("BLS12-381 8/57", P.bls12_381_config(),
                              1 << 12)):
        spec = L.FieldSpec(cfg.modulus)
        for width in (1, cfg.width, cfg.width ** 2):
            a, b = (rand_words(torch, rng, spec.modulus >> 224,
                               width * lanes, dev) for _ in range(2))
            err = max(err, check(
                f"mont_mul Poseidon {name} (8, {width} x {lanes})",
                FK.mont_mul(a, b, spec), FK.mont_mul_plain(a, b, spec)))
    bms, by = bound_ms(2 * n * 96, 2 * n * MUL_OPS)
    kernels.append(_entry("mont_mul", "zelana_tpu_torch/csrc/field_kernels.cu",
                          "zelana_tpu/ops/pallas_field.py:136", err, ms,
                          plain, bms, by))

    kernels.append(_ntt_kernel(torch, dev, rng, check, report))

    # runscan, four variants, on a real schedule over a 2^12-point pool;
    # bucket_tail on that schedule's level-2 emit
    npool = 1 << 12
    scalars = [int.from_bytes(rng.bytes(32), "little") % FR
               for _ in range(npool)]
    digits = MSM.scalar_digits(scalars)
    rs_err = bt_err = 0
    rs = {"ms": 0.0, "plain": 0.0, "bytes": 0.0, "ops": 0.0}
    bt = {"ms": 0.0, "plain": 0.0, "bytes": 0.0, "ops": 0.0}
    for curve, G, gen in (("g1", G1, G1.generator()),
                          ("g2", G2, G2.generator())):
        pts, acc = [], gen
        for _ in range(npool):
            pts.append(acc)
            acc = G.add(acc, gen)
        prep = (MSM.prepare_g1 if curve == "g1" else MSM.prepare_g2)(pts, dev)
        d = MSM._upload(MSM.build_schedule(digits), dev)
        pool = prep[0]
        C = CK.rows(curve)
        emit = CK.runscan(pool, d["pid"], d["flag"], curve)
        rs_err = max(rs_err, check(
            f"runscan {curve} affine", emit,
            CK.runscan_plain(pool, d["pid"], d["flag"], curve)))
        pool2 = emit.view(C, -1)
        emit2 = CK.runscan(pool2, d["pos2"], d["flag2"], curve, proj_in=True)
        rs_err = max(rs_err, check(
            f"runscan {curve} projective", emit2,
            CK.runscan_plain(pool2, d["pos2"], d["flag2"], curve,
                             proj_in=True)))
        for src_pool, ids, f, proj in ((pool, d["pid"], d["flag"], False),
                                       (pool2, d["pos2"], d["flag2"], True)):
            rs["ms"] += cuda_ms(torch, lambda: CK.runscan(src_pool, ids, f,
                                                          curve, proj))
            rs["plain"] += cuda_ms(torch, lambda: CK.runscan_plain(
                src_pool, ids, f, curve, proj), 1, False)
            nbytes, ops = runscan_work(torch, src_pool, ids, f, curve, proj)
            rs["bytes"] += nbytes
            rs["ops"] += ops
        flat2 = emit2.view(C, -1)
        K = d["dense"].numel() // (MSM.SCAN_WINDOWS * MSM.SCAN_BUCKETS)
        bt_err = max(bt_err, check(
            f"bucket_tail {curve} (K {K})",
            CK.bucket_tail(flat2, d["dense"], K, curve),
            CK.bucket_tail_plain(flat2, d["dense"], K, curve)))
        bt["ms"] += cuda_ms(torch, lambda: CK.bucket_tail(flat2, d["dense"],
                                                          K, curve), 20)
        bt["plain"] += cuda_ms(torch, lambda: CK.bucket_tail_plain(
            flat2, d["dense"], K, curve), 1, False)
        nbytes, ops = tail_work(torch, flat2, d["dense"], K, curve)
        bt["bytes"] += nbytes
        bt["ops"] += ops
    bms, by = bound_ms(rs["bytes"], rs["ops"])
    kernels.append(_entry("runscan", "zelana_tpu_torch/csrc/curve_kernels.cu",
                          "zelana_tpu/ops/pallas_curve.py:510", rs_err,
                          rs["ms"], rs["plain"], bms, by))
    bms, by = bound_ms(bt["bytes"], bt["ops"])
    kernels.append(_entry("bucket_tail",
                          "zelana_tpu_torch/csrc/curve_kernels.cu",
                          "zelana_tpu/ops/pallas_curve.py:545", bt_err,
                          bt["ms"], bt["plain"], bms, by))

    # step: G1 / G2, general / mixed, at S = 2^14 over random field words
    # (the adds are straight-line formulas, so any words compare bit for
    # bit), one round and five rounds in one launch. Pool: reads from
    # [0, 2S), writes [2S, 3S), guard slots after; the whole pool is
    # compared, so slots outside the write block must come back untouched.
    S = 1 << 14
    st_err = 0
    for curve in ("g1", "g2"):
        C = CK.rows(curve)
        pool = torch.cat([rand_words(torch, rng, L.FQ.modulus >> 224,
                                     3 * S + 64, dev)
                          for _ in range(C // 8)])
        ia, ib = (torch.from_numpy(rng.integers(0, 2 * S, S).astype(
            np.int32)).to(dev) for _ in range(2))
        for mixed, rounds in ((False, 1), (True, 1), (False, 5), (True, 5)):
            kind = f"{'mixed' if mixed else 'general'}, {rounds} round(s)"
            got, want = pool.clone(), pool.clone()
            CK.step(got, 2 * S, S, curve, ia, ib, read_hi=2 * S, mixed=mixed,
                    rounds=rounds)
            CK.step_plain(want, 2 * S, S, curve, ia, ib, mixed=mixed,
                          rounds=rounds)
            st_err = max(st_err, check(f"step {curve} {kind} by ids", got,
                                       want))
            got, want = pool.clone(), pool.clone()
            CK.step(got, 2 * S, S, curve, base=0, mixed=mixed, rounds=rounds)
            CK.step_plain(want, 2 * S, S, curve, base=0, mixed=mixed,
                          rounds=rounds)
            st_err = max(st_err, check(f"step {curve} {kind} by pairing",
                                       got, want))
    st = _step_keygen_chunk(torch, dev, rng, check)
    st_err = max(st_err, st["err"])
    kernels.append(_entry("step", "zelana_tpu_torch/csrc/curve_kernels.cu",
                          "zelana_tpu/ops/pallas_curve.py:398", st_err,
                          st["ms"], st["plain"], st["bound_ms"],
                          st["bound_by"]))
    report["step_keygen_chunk"] = st
    kernels += _mimc_kernel(torch, dev, rng, check)
    kernels += _inversion_kernels(torch, dev, rng, check, report)
    for k in kernels:
        k["mismatches"] = mismatches[k["name"]]
        log(f"  {k['name']}: {k['ms']:.4f} ms kernel, {k['plain_ms']:.3f} ms "
            f"plain, bound {k['bound_ms']:.4f} ms ({k['bound_by']})")
    if any(mismatches.values()):
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{mismatches}")
    report["kernels_checked"] = [k["name"] for k in kernels]
    return kernels


# forced splits of the 2^13 transform: every two-pass split that fits a
# tile, three and more passes, and a pass per stage (the earlier launch
# pattern); of the 2^21 one, other three-pass splits
SPLITS_2_13 = [[k, 13 - k] for k in range(2, 12)] + [
    [5, 4, 4], [4, 5, 4], [4, 4, 5], [5, 5, 3], [6, 4, 3], [3, 3, 7],
    [1, 1, 11], [4, 3, 3, 3], [3, 3, 3, 2, 2], [1] * 13]
SPLITS_2_21 = [[8, 8, 5], [5, 8, 8], [8, 7, 6]]


def ntt_products(kind: str, log_n: int, built: bool = False) -> int:
    """Montgomery products one transform of 2^log_n elements needs. Stage s
    of the DIT network multiplies by w^k, k < 2^s, and one butterfly in
    2^s multiplies by w^0 = 1: (log_n - 2) 2^(log_n - 1) + 1 products over
    the stages (stage 0's are all by one). Then n for the scaling (1/n,
    g^j, or 1/n g^-j as one table) and, for the quotient, n for a b and n
    for 1/(Z n) g^-j as one table. `built`: what the pass kernel does,
    every product of stages 1 and up, (log_n - 1) 2^(log_n - 1), and the
    quotient's 1/Z apart."""
    n = 1 << log_n
    scale = {"ntt": 0, "intt": 1, "coset_ntt": 1, "coset_intt": 1,
             "quotient": 2}[kind]
    if built:
        return (log_n - 1) * n // 2 + (scale + (kind == "quotient")) * n
    return (log_n - 2) * n // 2 + 1 + scale * n


def witness_map_products(log_n: int, built: bool = False) -> int:
    """Montgomery products the witness map at 2^log_n needs: seven
    transforms' stages, n for a b, and n for each of four tables the
    scalings fold into by linearity: 1/n g^j before each coset NTT (the
    iNTT's 1/n in it) and 1/(Z n) g^-j after the quotient. `built`: the
    passes as built, which scale by 1/n, g^j and 1/Z apart (9 n)."""
    kinds = ["intt"] * 3 + ["coset_ntt"] * 3 + ["quotient"]
    if built:
        return sum(ntt_products(k, log_n, True) for k in kinds)
    return 7 * ntt_products("ntt", log_n) + 5 * (1 << log_n)


def _ntt_kernel(torch, dev, rng, check, report) -> dict:
    """The NTT pass kernel against ntt_pass_plain, whole outputs: the five
    kinds of transform (the four and the witness map's quotient) at 2^13
    and 2^21 by the launcher's split, and every forced split in
    SPLITS_2_13 / SPLITS_2_21 of each; the time of each (2^13: device
    time; 2^21: CUDA events) beside its operation bound, the forced
    splits' too; a one-element fill's device time, the floor of a launch;
    the L2 witness map as a whole. Returns the kernels-line entry: ms /
    plain_ms / bound_ms of one 2^21 ntt."""
    from zelana_tpu_torch.fields.bn254 import R as FR
    from zelana_tpu_torch.ops import ntt as NTT

    rep = report["ntt_pass"] = {}
    one = torch.zeros(1, dtype=torch.int32, device=dev)
    rep["fill_1_device_ms"] = device_ms(torch, one.zero_, 50, kernels=1)
    log(f"  a one-element fill (the floor of a launch): "
        f"{rep['fill_1_device_ms']:.5f} ms of device time")
    err = 0
    entry = None
    for log_n, splits in ((13, SPLITS_2_13), (21, SPLITS_2_21)):
        # 2^13 by device time over 50 calls (the profiler can drop a
        # window's first kernels), 2^21 by CUDA events (launches are not
        # the limit there)
        how = "of device time" if log_n == 13 else "by events"

        def timed(fn, passes):
            return (device_ms(torch, fn, 50, kernels=passes) if log_n == 13
                    else cuda_ms(torch, fn, 10))

        n = 1 << log_n
        plan = NTT.make_plan(n)
        plan.on(dev)  # the device tables, made once, outside the timings
        xs = [rand_words(torch, rng, FR >> 224, n, dev) for _ in range(3)]
        for kind in NTT.KINDS:
            ins = xs if kind == "quotient" else xs[:1]
            t0 = time.time()
            want = NTT.transform_split(kind, ins, plan, plain=True)
            torch.cuda.synchronize()
            plain_ms = (time.time() - t0) * 1e3
            split = NTT.default_split(log_n)
            err = max(err, check(f"ntt_pass {kind} 2^{log_n} {split}",
                                 NTT.transform_split(kind, ins, plan),
                                 want))
            for forced in splits:
                err = max(err, check(
                    f"ntt_pass {kind} 2^{log_n} forced {forced}",
                    NTT.transform_split(kind, ins, plan, forced), want))
            ms = timed(lambda: NTT.transform_split(kind, ins, plan),
                       len(split))
            # inputs, output, the twiddle table and the g^j / 1/n g^-j one
            tables = 1 + (kind not in ("ntt", "intt"))
            bms, by = bound_ms(32 * n * (len(ins) + 1 + tables),
                               ntt_products(kind, log_n) * MUL_OPS)
            # the operations of the passes as built, beside the bound
            built = ntt_products(kind, log_n, True) * MUL_OPS / \
                INT32_OPS_PER_S * 1e3
            rep[f"{kind} 2^{log_n}"] = {
                "split": split, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bms, "bound_by": by, "built_bound_ms": built}
            log(f"  ntt_pass {kind} 2^{log_n} {split}: {ms:.5f} ms {how}, "
                f"bound {bms:.5f} ms ({by}), {bms / ms:.1%} of it (the "
                f"passes as built {built:.5f} ms); plain {plain_ms:.1f} ms")
            if kind == "ntt" and log_n == 21:
                entry = _entry("ntt_pass",
                               "zelana_tpu_torch/csrc/ntt_kernels.cu",
                               "zelana_tpu/ops/pallas_field.py:462", 0, ms,
                               plain_ms, bms, by)
                entry["built_bound_ms"] = built
        for forced in splits:
            ms = timed(lambda: NTT.transform_split("ntt", xs[:1], plan,
                                                   forced), len(forced))
            rep[f"ntt 2^{log_n} forced {forced}"] = ms
            log(f"  ntt_pass ntt 2^{log_n} forced {forced}: {ms:.5f} ms "
                f"{how}")
        del xs
    entry["max_abs_err"] = err
    small = rep["ntt 2^13"]
    entry.update(l2_ms=small["ms"], l2_bound_ms=small["bound_ms"],
                 l2_bound_by=small["bound_by"])
    _l2_witness_map(torch, dev, rng, check, entry, report)
    return entry


def _l2_witness_map(torch, dev, rng, check, entry, report) -> None:
    """The witness map at the L2 prove's domain (2^13) as a whole: against
    its plain version, its launches (7 transforms x default_split(13)), and
    its time by device time and by CUDA events beside its bound."""
    from zelana_tpu_torch.fields.bn254 import R as FR
    from zelana_tpu_torch.groth16.prove import witness_map
    from zelana_tpu_torch.ops import cuda
    from zelana_tpu_torch.ops import ntt as NTT

    log_n = 13
    n = 1 << log_n
    plan = NTT.make_plan(n)
    evals = [rand_words(torch, rng, FR >> 224, n, dev) for _ in range(3)]
    torch.cuda.synchronize()
    cuda.reset_launches()
    h = witness_map(evals, plan)
    torch.cuda.synchronize()
    launches = {k: v for k, v in cuda.LAUNCHES.items() if v}
    want = 7 * len(NTT.default_split(log_n))
    if launches != {"ntt_pass": want}:
        raise AssertionError(f"2^13 witness map launched {launches}, not "
                             f"{want} ntt_pass")
    entry["max_abs_err"] = max(entry["max_abs_err"], check(
        "ntt_pass witness map 2^13", h, witness_map(evals, plan, plain=True)))
    ms = device_ms(torch, lambda: witness_map(evals, plan), kernels=want)
    ev = cuda_ms(torch, lambda: witness_map(evals, plan), 20)
    products = witness_map_products(log_n)
    bms, by = bound_ms(32 * n * 4, products * MUL_OPS)
    built = witness_map_products(log_n, built=True)
    report["witness_map_2_13"] = {
        "device_ms": ms, "events_ms": ev, "launches": launches,
        "bound_ms": bms, "bound_by": by, "products": products,
        "built_products": built}
    log(f"  witness map 2^13 (the L2 prove's): {ms:.5f} ms of device time, "
        f"{ev:.4f} ms by events, launches {launches}; bound {bms:.5f} ms "
        f"({by}, {products} products; the passes as built do {built}), "
        f"{bms / ms:.1%} of it")


def _step_keygen_chunk(torch, dev, rng, check) -> dict:
    """Keygen's five step rounds on one FB_CHUNK-scalar chunk, as
    fixed_base._run_fb launches them (one launch per curve: round 0 by slot
    ids into the window table, rounds 1-4 in the kernel), for G1 and for G2:
    kernel against five single plain rounds over the whole pool (head + n
    slots), and the time of the launch summed over both curves beside its
    bound. The bound counts the table head read once, the two id arrays,
    the n sums written, and 12 (G1) or 42 (G2) Montgomery products for each
    of the 31 n adds of the five rounds."""
    import numpy as np

    from zelana_tpu_torch.curves import g1 as G1, g2 as G2
    from zelana_tpu_torch.fields.bn254 import R as FR
    from zelana_tpu_torch.ops import curve_kernels as CK
    from zelana_tpu_torch.ops import fixed_base as FB
    from zelana_tpu_torch.ops import limbs as L
    from zelana_tpu_torch.r1cs.native_synth import fr_array, words32

    n = FB.FB_CHUNK
    out = {"err": 0, "ms": 0.0, "plain": 0.0, "bytes": 0.0, "ops": 0.0}
    scalars = [int.from_bytes(rng.bytes(32), "little") % FR
               for _ in range(n)]
    scalars[:3] = [0, 1, FR - 1]
    words = L.to_tensor(words32(fr_array(scalars)), dev)
    ia, ib = FB._slot_ids(words)
    S = n * FB.N_WINDOWS // 2
    head_n = FB.N_TABLE + 1
    for curve, prep, gen in (("g1", FB.prepare_table_g1, G1.generator()),
                             ("g2", FB.prepare_table_g2, G2.generator())):
        C = CK.rows(curve)
        head = prep(gen, dev)[1]
        pool = torch.zeros((C, head_n + n), dtype=torch.int32, device=dev)
        pool[:, :head_n] = head

        def rounds(p, plain=False):
            if plain:
                return CK.step_plain(p, head_n, S, curve, ia, ib,
                                     rounds=FB.ROUNDS)
            return CK.step(p, head_n, S, curve, ia, ib, read_hi=head_n,
                           rounds=FB.ROUNDS)

        got = rounds(pool.clone())
        want = rounds(pool.clone(), plain=True)
        out["err"] = max(out["err"], check(
            f"step {curve} keygen chunk ({n} scalars, 5 rounds in one "
            f"launch)", got, want))
        work = pool.clone()
        out["ms"] += cuda_ms(torch, lambda: rounds(work), 5)
        out["plain"] += cuda_ms(torch, lambda: rounds(work, True), 1, False)
        muls = 12 if curve == "g1" else 42
        out["bytes"] += head_n * C * 4 + 2 * S * 4 + n * C * 4
        out["ops"] += (2 * S - n) * muls * MUL_OPS  # S + S/2 + ... + n adds
        del pool, got, want, work
    out["bound_ms"], out["bound_by"] = bound_ms(out["bytes"], out["ops"])
    log(f"  step, one keygen chunk, G1 + G2: {out['ms']:.4f} ms kernel, "
        f"{out['plain']:.1f} ms plain, bound {out['bound_ms']:.4f} ms "
        f"({out['bound_by']})")
    return out


def _mimc_kernel(torch, dev, rng, check) -> list:
    """mimc_permute at 2^14 against its plain version: the 91 MiMC rounds,
    and 3 rounds of the JAX test's constants; times of the 91 rounds."""
    from zelana_tpu_torch.fields.bn254 import R as FR
    from zelana_tpu_torch.hashes import mimc_batch as MB
    from zelana_tpu_torch.ops import field_kernels as FK
    from zelana_tpu_torch.ops import limbs as L

    n = 1 << 14
    x = rand_words(torch, rng, FR >> 224, n, dev)
    x[:, :3] = L.to_tensor(L.to_words([0, 1, FR - 1]), dev)
    rc91 = MB._round_constants(dev)
    rc3 = L.to_tensor(L.encode_mont([7, 12345, 0xDEADBEEF], L.FR).T, dev)
    err = 0
    for rc in (rc91, rc3):
        err = max(err, check(f"mimc_permute {rc.shape[0]} rounds",
                             FK.mimc_permute(x, rc, L.FR),
                             FK.mimc_permute_plain(x, rc, L.FR)))
    ms = cuda_ms(torch, lambda: FK.mimc_permute(x, rc91, L.FR), 20)
    plain = cuda_ms(torch, lambda: FK.mimc_permute_plain(x, rc91, L.FR), 1,
                    False)
    bms, by = bound_ms(n * 64 + rc91.numel() * 4,
                       n * 4 * rc91.shape[0] * MUL_OPS)
    return [_entry("mimc_permute", "zelana_tpu_torch/csrc/field_kernels.cu",
                   "zelana_tpu/ops/pallas_field.py:378", err, ms, plain, bms,
                   by)]


def fermat_muls(modulus: int) -> int:
    """Products of the left-to-right square-and-multiply for a^(p-2)."""
    e = modulus - 2
    return e.bit_length() - 1 + bin(e).count("1") - 1


# 32-bit integer operations of inv_base_kernel's safegcd per element, from
# field.cuh's source (a 32x32 -> 64-bit product or a 64-bit add or shift
# counts 2): 20 batches of 30 divsteps (27 operations each), update_de
# (9 limbs x (6 products, 6 adds, mask and shift) + the md / me fix-up)
# and update_fg (9 x (4 products, 4 adds, mask and shift)); then the
# normalisation, the limb conversions and one Montgomery product by R^3
SAFEGCD_OPS = 20 * (30 * 27 + (9 * 30 + 12) + 9 * 22) + 60 + 40 + 2 * MUL_OPS


def inv_work(name: str, n: int, spec):
    """(bytes moved, int32 operations) of one inversion kernel over n
    elements: inv_fwd reads a and writes the prefixes and the chain totals
    with one multiply per element, inv_bwd reads a, the prefixes and the
    totals' inverses and writes the result with two, inv_base reads and
    writes each element with the safegcd's SAFEGCD_OPS operations
    ("inv_base ladder" counts those of the a^(p-2) ladder, the function's
    plain definition and the bound of earlier runs)."""
    from zelana_tpu_torch.ops import field_kernels as FK

    if name == "inv_base":
        return 2 * n * 32, n * SAFEGCD_OPS
    if name == "inv_base ladder":
        return 2 * n * 32, n * fermat_muls(spec.modulus) * MUL_OPS
    chains = FK.inv_chains(n)
    if name == "inv_fwd":
        return (2 * n + chains) * 32, n * MUL_OPS
    return (3 * n + chains) * 32, 2 * n * MUL_OPS


# the levels of one 2^20 inversion, and the partial last tiles
INV_PATH = (1 << 20, 1 << 16, 4096)
INV_EDGE = (20480, 19456)
INV_ZEROS = (1 << 20, 20480)  # inputs with zeros
# inv_fwd's and inv_bwd's two thread mappings timed against each other
# across the launchers' thresholds (zt_inv_scan_below)
INV_SWEEP = (4096, 1 << 16, 1 << 17, 1 << 18, 1 << 19, 1 << 20)


def _with_zeros(rng, a):
    """a with zeros at its first and last element and at 64 random
    places."""
    import numpy as np

    n = a.shape[1]
    a[:, [0, n - 1, *rng.choice(np.arange(1, n - 1), 64,
                                replace=False).tolist()]] = 0
    return a


def _inversion_kernels(torch, dev, rng, check, report) -> list:
    """The three inversion kernels against their plain versions on the
    same inputs, whole outputs compared: inv_fwd (prefixes and totals) and
    inv_bwd over Fr and Fq at the levels of a 2^20 inversion (2^20: the
    long mappings; 2^16 and 4,096: the scans) and at 20,480 and 19,456
    (partial last tiles of four and three steps); both on inputs with
    zeros at 2^20 and 20,480 over Fr (the long mappings and the scans),
    zeros at the first and last element and at random places; inv_base over Fr, Fq and BLS12-381 Fr at
    1,024 and 2^16 random elements and the edges 0, 1, 2, p - 1 and R mod
    p. Times: inv_fwd and inv_bwd per level of a 2^20 Fr inversion (their
    sums are their entries; PERF.md says what inv_fwd's entry summed
    before), inv_base at its recursion-base shape, 1,024 Fr, and on one
    warp (32 elements: the one-thread latency floor); the kernels'
    device time from the profiler, CUDA events beside it (`events_ms`).
    Both thread mappings of inv_fwd and of inv_bwd, forced, checked and
    timed over Fr at INV_SWEEP: the evidence for the launchers'
    thresholds."""
    from zelana_tpu_torch.ops import field_kernels as FK
    from zelana_tpu_torch.ops import limbs as L

    rep = report["inversion_kernels"] = {}
    err = {"inv_fwd": 0, "inv_bwd": 0, "inv_base": 0}
    t = {k: {"ms": 0.0, "events": 0.0, "plain": 0.0, "bytes": 0.0,
             "ops": 0.0} for k in err}

    def timed(name, key, fn, pfn, width, spec, cold=None):
        """ms: the kernel's device time (profiler), over `cold` where given
        (fn over copies of its inputs in turn, so that each launch reads
        them from HBM, as the bound assumes; warm_ms: fn on one input, part
        of it left in the 50 MB L2 by the launch before); events_ms: CUDA
        events around back-to-back calls, the host's launches included."""
        ms = device_ms(torch, cold or fn, kernels=1)
        events = cuda_ms(torch, fn, 20)
        plain = cuda_ms(torch, pfn, 1, False)
        nbytes, ops = inv_work(name, width, spec)
        bms, by = bound_ms(nbytes, ops)
        rep[key] = {"ms": ms, "events_ms": events, "plain_ms": plain,
                    "bound_ms": bms, "bound_by": by}
        warm = ""
        if cold:
            rep[key]["warm_ms"] = device_ms(torch, fn, kernels=1)
            warm = f", {rep[key]['warm_ms']:.4f} on one input (warm L2)"
        log(f"  {key}: {ms:.4f} ms on the device{warm} ({events:.4f} ms by "
            f"CUDA events around back-to-back calls), plain {plain:.2f} ms, "
            f"bound {bms:.4f} ms ({by})")
        t[name]["ms"] += ms
        t[name]["events"] += events
        t[name]["plain"] += plain
        t[name]["bytes"] += nbytes
        t[name]["ops"] += ops

    def fwd_check(what, got, want):
        return max(check(f"inv_fwd {what} prefix", got[0], want[0]),
                   check(f"inv_fwd {what} totals", got[1], want[1]))

    for spec, fname in ((L.FR, "Fr"), (L.FQ, "Fq")):
        top = spec.modulus >> 224
        for n in INV_PATH + INV_EDGE:
            a = rand_words(torch, rng, top, n, dev)
            err["inv_fwd"] = max(err["inv_fwd"], fwd_check(
                f"{fname} {n}", FK.inv_fwd(a, spec),
                FK.inv_fwd_plain(a, spec)))
            if spec is L.FR and n in INV_PATH:
                timed("inv_fwd", f"inv_fwd Fr {n}",
                      lambda: FK.inv_fwd(a, spec),
                      lambda: FK.inv_fwd_plain(a, spec), n, spec,
                      rotating(lambda x: FK.inv_fwd(x, spec),
                               [(a,), *((a.clone(),) for _ in range(3))])
                      if n == 1 << 20 else None)
            pre = rand_words(torch, rng, top, n, dev)
            tinv = rand_words(torch, rng, top, FK.inv_chains(n), dev)
            err["inv_bwd"] = max(err["inv_bwd"], check(
                f"inv_bwd {fname} {n}", FK.inv_bwd(a, pre, tinv, spec),
                FK.inv_bwd_plain(a, pre, tinv, spec)))
            if spec is L.FR and n in INV_PATH:
                timed("inv_bwd", f"inv_bwd Fr {n}",
                      lambda: FK.inv_bwd(a, pre, tinv, spec),
                      lambda: FK.inv_bwd_plain(a, pre, tinv, spec), n, spec,
                      rotating(lambda x, y: FK.inv_bwd(x, y, tinv, spec),
                               [(a, pre), (a.clone(), pre.clone())])
                      if n == 1 << 20 else None)
    spec, top = L.FR, L.FR.modulus >> 224
    for n in INV_ZEROS:
        a = _with_zeros(rng, rand_words(torch, rng, top, n, dev))
        err["inv_fwd"] = max(err["inv_fwd"], fwd_check(
            f"Fr {n} zeros", FK.inv_fwd(a, spec), FK.inv_fwd_plain(a, spec)))
        pre = rand_words(torch, rng, top, n, dev)
        tinv = rand_words(torch, rng, top, FK.inv_chains(n), dev)
        err["inv_bwd"] = max(err["inv_bwd"], check(
            f"inv_bwd Fr {n} zeros", FK.inv_bwd(a, pre, tinv, spec),
            FK.inv_bwd_plain(a, pre, tinv, spec)))
    for spec, fname in ((L.FR, "Fr"), (L.FQ, "Fq"),
                        (L.BLS_FR, "BLS12-381 Fr")):
        p = spec.modulus
        edges = L.to_tensor(L.to_words([0, 1, 2, p - 1, (1 << 256) % p]),
                            dev)
        for n in (FK.INV_BLOCK, 1 << 16):
            a = torch.cat([rand_words(torch, rng, p >> 224, n, dev), edges],
                          dim=1)
            err["inv_base"] = max(err["inv_base"], check(
                f"inv_base {fname} {n} + 5 edges", FK.inv_base(a, spec),
                FK.inv_base_plain(a, spec)))
        if spec is L.FR:
            base = a[:, :FK.INV_BLOCK].contiguous()
            timed("inv_base", f"inv_base Fr {FK.INV_BLOCK}",
                  lambda: FK.inv_base(base, spec),
                  lambda: FK.inv_base_plain(base, spec), FK.INV_BLOCK, spec)
            ladder = bound_ms(*inv_work("inv_base ladder", FK.INV_BLOCK,
                                        spec))
            warp = a[:, :32].contiguous()
            floor = device_ms(torch, lambda: FK.inv_base(warp, spec),
                              kernels=1)
            rep["inv_base ladder"] = {
                "per_element": fermat_muls(p) * MUL_OPS,
                "bound_ms": ladder[0], "bound_by": ladder[1],
                "one_warp_ms": floor}
            log(f"  inv_base: {SAFEGCD_OPS} integer operations an element "
                f"(the ladder: {fermat_muls(p) * MUL_OPS} multiplies, bound "
                f"at 1,024 {ladder[0]:.5f} ms ({ladder[1]})); one warp (32 "
                f"elements): {floor:.4f} ms")
    _inv_mappings(torch, dev, rng, check, rep, err, "inv_fwd")
    _inv_mappings(torch, dev, rng, check, rep, err, "inv_bwd")
    out = []
    for name, line in (("inv_fwd", 247), ("inv_bwd", 274), ("inv_base", 228)):
        bms, by = bound_ms(t[name]["bytes"], t[name]["ops"])
        out.append(_entry(name, "zelana_tpu_torch/csrc/field_kernels.cu",
                          f"zelana_tpu/ops/pallas_field.py:{line}",
                          err[name], t[name]["ms"], t[name]["plain"], bms,
                          by))
        out[-1]["events_ms"] = t[name]["events"]
    out[-1]["ladder_bound_ms"] = rep["inv_base ladder"]["bound_ms"]
    out[-1]["ladder_bound_by"] = rep["inv_base ladder"]["bound_by"]
    return out


def _inv_mappings(torch, dev, rng, check, rep, err, name) -> None:
    """The two thread mappings of `name` (inv_fwd or inv_bwd) forced at
    each n of INV_SWEEP over Fr: each whole output against the plain
    version, and each mapping's device time beside the one the launcher
    picks."""
    from zelana_tpu_torch.ops import cuda
    from zelana_tpu_torch.ops import field_kernels as FK
    from zelana_tpu_torch.ops import limbs as L

    spec, top = L.FR, L.FR.modulus >> 224
    long = "a thread a chain" if name == "inv_fwd" else "two threads a chain"
    res = rep[f"{name} mappings"] = {}
    for n in INV_SWEEP:
        a = rand_words(torch, rng, top, n, dev)
        if name == "inv_fwd":  # (prefixes, totals)
            want = FK.inv_fwd_plain(a, spec)
            mapped = functools.partial(FK.inv_fwd_mapped, a, spec)
        else:  # (out,)
            pre = rand_words(torch, rng, top, n, dev)
            tinv = rand_words(torch, rng, top, FK.inv_chains(n), dev)
            want = (FK.inv_bwd_plain(a, pre, tinv, spec),)

            def mapped(scan, a=a, pre=pre, tinv=tinv):
                return (FK.inv_bwd_mapped(a, pre, tinv, spec, scan),)
        ms = {}
        for scan, what in ((False, long), (True, "scan")):
            fn = functools.partial(mapped, scan)
            err[name] = max(err[name], *(
                check(f"{name} Fr {n}, {what} forced, output {k}", g, w)
                for k, (g, w) in enumerate(zip(fn(), want))))
            ms[what] = device_ms(torch, fn, kernels=1)
        below = cuda.lib("field_kernels").zt_inv_scan_below(
            int(name == "inv_bwd"))
        picked = "scan" if FK.inv_chains(n) < below else long
        res[str(n)] = {**ms, "picked": picked}
        log(f"  {name} Fr {n}: {long} {ms[long]:.4f} ms, scan "
            f"{ms['scan']:.4f} ms (device time); the launcher picks the "
            f"{picked}")


def _entry(name, source, replaces, err, ms, plain, bms, by) -> dict:
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
            "library_ms": None}


# ---------------------------------------------------------------------------
# the batched hashes and the batch inversion at realistic sizes
# ---------------------------------------------------------------------------


def _sample_ints(torch, words, idx, spec):
    from zelana_tpu_torch.ops import limbs as L

    return L.decode_mont(L.to_numpy(words[:, idx]), spec)


def phase_hashes(torch, dev, report) -> dict:
    """Returns the kernel launches of the hashing path."""
    import numpy as np

    from zelana_tpu_torch.hashes import mimc as M
    from zelana_tpu_torch.hashes import mimc_batch as MB
    from zelana_tpu_torch.hashes import poseidon as P
    from zelana_tpu_torch.hashes import poseidon_batch as PB
    from zelana_tpu_torch.ops import cuda
    from zelana_tpu_torch.ops import field_kernels as FK
    from zelana_tpu_torch.ops import limbs as L

    rng = np.random.default_rng(7)
    rep = report["hashes"] = {}
    fr_top = L.FR.modulus >> 224
    n2 = 1 << 20
    leaves = [rand_words(torch, rng, fr_top, n2, dev) for _ in range(2)]
    cols5 = [rand_words(torch, rng, fr_top, 1 << 16, dev) for _ in range(5)]
    pos = []
    for name, cfg, n in (("poseidon bn254 8/56", P.bn254_config(), 1 << 15),
                         ("poseidon bn254 8/57", P.bn254_config_57(), 1 << 12),
                         ("poseidon bls12-381 8/57", P.bls12_381_config(),
                          1 << 12)):
        top = cfg.modulus >> 224
        pos.append((name, cfg, [rand_words(torch, rng, top, n, dev)
                                for _ in range(2)]))
    runs = [("hash2_batch 2^20", lambda: MB.hash2_batch(*leaves), leaves,
             L.FR, lambda r: M.hash_2(*r)),
            ("hash_n_batch 3 cols 2^16", lambda: MB.hash_n_batch(cols5[:3]),
             cols5[:3], L.FR, lambda r: M.hash_n(*r)),
            ("hash_n_batch 5 cols 2^16", lambda: MB.hash_n_batch(cols5),
             cols5, L.FR, lambda r: M.hash_n(*r))]
    for name, cfg, cols in pos:
        runs.append((f"{name} 2 cols {cols[0].shape[1]}",
                     lambda cfg=cfg, cols=cols: PB.poseidon_hash_batch(
                         cfg, cols),
                     cols, L.FieldSpec(cfg.modulus),
                     lambda r, cfg=cfg: P.poseidon_hash(cfg, list(r))))

    torch.cuda.synchronize()
    cuda.reset_launches()
    outs, launches = [], {}
    for name, fn, _, _, _ in runs:
        before = dict(cuda.LAUNCHES)
        t0 = time.time()
        outs.append(fn())
        torch.cuda.synchronize()
        launches[name] = {k: v - before[k] for k, v in cuda.LAUNCHES.items()
                          if v != before[k]}
        rep[name] = {"first_call_s": time.time() - t0,
                     "launches": launches[name]}
    # mont_mul's launches on the main path are Poseidon's rounds
    path = {k: cuda.LAUNCHES[k] for k in ("mimc_permute", "mont_mul")}
    log(f"launches on the hashing path: {dict(cuda.LAUNCHES)}")

    for (name, fn, cols, spec, host), out in zip(runs, outs):
        n = out.shape[1]
        if tuple(out.shape) != (L.NWORDS, n):
            raise AssertionError(f"{name}: output shape {tuple(out.shape)}")
        idx = torch.from_numpy(rng.choice(n, 256, replace=False)).to(dev)
        rows = list(zip(*(_sample_ints(torch, c, idx, spec) for c in cols)))
        want = [host(r) for r in rows]
        if _sample_ints(torch, out, idx, spec) != want:
            raise AssertionError(f"{name}: sampled outputs differ from the "
                                 f"host hash")
        ms = cuda_ms(torch, fn, 3)
        rep[name]["ms"] = ms
        rep[name]["per_s"] = n / ms * 1e3
        log(f"  {name}: {ms:.3f} ms on the card ({n / ms * 1e3:.4g} hashes/s),"
            f" first call {rep[name]['first_call_s']:.2f} s, launches "
            f"{launches[name]}; 256 samples equal to the host hash")
    x = leaves[0]
    rc = MB._round_constants(dev)
    # the kernel against its plain version, whole outputs, at the path's
    # widths and at one off the 256-thread block (its masked last block)
    odd = leaves[1][:, :(1 << 16) + 77].contiguous()
    for what, xs in (("2^20", x), ("2^16", cols5[0]), ("2^16 + 77", odd)):
        mism, err = compare(torch, FK.mimc_permute(xs, rc, L.FR),
                            FK.mimc_permute_plain(xs, rc, L.FR))
        log(f"  mimc_permute {what}, 91 rounds, whole output against the "
            f"plain version: mismatches {mism}, max |diff| {err}")
        if mism:
            raise AssertionError(f"mimc_permute {what}: {mism} columns "
                                 f"differ from the plain version")
    ms = cuda_ms(torch, lambda: FK.mimc_permute(x, rc, L.FR), 5)
    bms, by = bound_ms(n2 * 64, n2 * 4 * rc.shape[0] * MUL_OPS)
    rep["mimc_permute 2^20"] = {"ms": ms, "bound_ms": bms, "bound_by": by}
    log(f"  mimc_permute 2^20, 91 rounds: {ms:.3f} ms, bound {bms:.3f} ms "
        f"({by})")
    return path


def phase_inversion(torch, dev, report) -> dict:
    """Returns the kernel launches of one 2^20 Fr inversion."""
    import numpy as np

    from zelana_tpu_torch.ops import cuda
    from zelana_tpu_torch.ops import field_kernels as FK
    from zelana_tpu_torch.ops import limbs as L

    rng = np.random.default_rng(11)
    rep = report["inversion"] = {}
    path = None
    # (field, n, layout): "" a fresh tensor; the rest take the function's
    # copy path: a ragged n, a column slice of an (8, n + 1) tensor (not
    # contiguous, 4 bytes off), and a contiguous view 4 bytes off
    for spec, fname, n, layout in (
            (L.FR, "Fr", 1 << 20, ""), (L.FR, "Fr", 20480, ""),
            (L.FR, "Fr", 20480 - 77, " (ragged)"),
            (L.FR, "Fr", 20480, " (column slice)"),
            (L.FR, "Fr", 20480, " (misaligned view)"),
            (L.FQ, "Fq", 1 << 20, "")):
        name = f"mont_batch_inv_nested {fname} {n}{layout}"
        top = spec.modulus >> 224
        if layout == " (column slice)":
            a = rand_words(torch, rng, top, n + 1, dev)[:, 1:]
        elif layout == " (misaligned view)":
            flat = rand_words(torch, rng, top, n + 1, dev).reshape(-1)
            a = flat[1:1 + L.NWORDS * n].view(L.NWORDS, n)
        else:
            a = rand_words(torch, rng, top, n, dev)
        if layout in (" (column slice)", " (misaligned view)") and (
                a.data_ptr() % 16 == 0 or (
                    layout == " (column slice)") == a.is_contiguous()):
            raise AssertionError(f"{name}: the view is not the layout named")
        zeros = [0, n - 1, *rng.choice(np.arange(1, n - 1), 6,
                                       replace=False).tolist()]
        a[:, zeros] = 0
        torch.cuda.synchronize()
        cuda.reset_launches()
        t0 = time.time()
        inv = L.mont_batch_inv_nested(a, spec)
        torch.cuda.synchronize()
        first = time.time() - t0
        launches = {k: v for k, v in cuda.LAUNCHES.items() if v}
        if path is None:
            path = {k: cuda.LAUNCHES[k] for k in ("inv_fwd", "inv_bwd",
                                                  "inv_base")}
            if path != {"inv_fwd": 3, "inv_bwd": 3, "inv_base": 1}:
                raise AssertionError(f"{name}: launches {path}, expected 3 "
                                     f"inv_fwd, 3 inv_bwd, 1 inv_base")
        # the plain recursion on the zero-swapped input, padded with ones
        # (the function pads with zeros and counts them as ones inside
        # the kernels)
        one = L.broadcast(spec.one_mont, n, dev)
        zero = L.is_zero(a)
        pad = L.broadcast(spec.one_mont, -n % FK.INV_BLOCK, dev)
        plain = FK.batch_inv(torch.cat([L.select(zero, one, a), pad], dim=1),
                             spec, plain=True)[:, :n]
        mism, _ = compare(torch, inv,
                          L.select(zero, torch.zeros_like(plain), plain))
        prod = FK.mont_mul(a.contiguous(), inv, spec)
        want = L.select(zero, torch.zeros_like(one), one)
        bad = int((prod != want).any(dim=0).sum())
        if mism or bad or int(zero.sum()) != len(zeros) or \
                inv[:, zero].any():
            raise AssertionError(f"{name}: {mism} columns differ from the "
                                 f"plain version, {bad} products a * inv "
                                 f"wrong, or a zero not kept")
        ms = cuda_ms(torch, lambda: L.mont_batch_inv_nested(a, spec), 5)
        rep[name] = {"ms": ms, "first_call_s": first, "launches": launches}
        log(f"  {name}: {ms:.3f} ms on the card (first call {first:.3f} s), "
            f"launches {launches}; equal to the plain version, a * inv == 1 "
            f"({len(zeros)} zeros kept)")
        if n == 1 << 20 and spec is L.FR:
            _inversion_profile(torch, a, spec, rep)
    return path


# device kernels of one 2^20 inversion, by name
INV_PROFILE = {"inv_fwd_kernel": 1, "inv_fwd_scan_kernel": 2,
               "inv_bwd_kernel": 1, "inv_bwd_scan_kernel": 2,
               "inv_base_kernel": 1}


def _inversion_profile(torch, a, spec, rep, reps: int = 10) -> None:
    """`reps` 2^20 inversions back to back under torch.profiler: device
    time by kernel and per inversion; the run fails if any device kernel
    but the port's inversion kernels ran (the zero handling is inside
    them). The profiler can drop the first kernels of a window, so the
    window holds several inversions and the counts are logged against
    INV_PROFILE. Each level's kernels are timed in `kernels`."""
    from zelana_tpu_torch.ops import limbs as L

    n = a.shape[1]
    L.mont_batch_inv_nested(a, spec)
    torch.cuda.synchronize()

    def ours(key):  # "void inv_fwd_kernel<1>(...)" -> "inv_fwd_kernel"
        name = key.split("<")[0].split()[-1] if key.strip() else ""
        return name if name in INV_PROFILE else None

    for _ in range(5):  # a window that missed a kernel is profiled again
        with profiled(torch) as prof:
            for _ in range(reps):
                L.mont_batch_inv_nested(a, spec)
        events = device_events(prof, empty_ok=True)
        others = [e.key for e in events if ours(e.key) is None]
        counts = {k: sum(e.count for e in events if ours(e.key) == k)
                  for k in INV_PROFILE}
        if all(counts.values()):
            break
    kern = sum(e.self_device_time_total for e in events) / 1e3
    per = kern / max(counts["inv_base_kernel"], 1)
    rep[f"profile {n}"] = {
        "inversions": reps, "kernels_ms": kern, "per_inversion_ms": per,
        "counts": counts, "others": others,
        "by_kernel": [(e.key[:90], e.count, e.self_device_time_total / 1e3)
                      for e in events]}
    log(f"    {reps} {n} inversions under the profiler: the port's kernels "
        f"{kern:.4f} ms of device time, {per:.4f} ms an inversion (over "
        f"{counts['inv_base_kernel']} base launches); kernels seen {counts} "
        f"(expected {reps} x {INV_PROFILE}); other device kernels: "
        f"{others or 'none'}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total):
        log(f"      {e.self_device_time_total / 1e3:8.4f} ms  "
            f"x{e.count:<3d} {e.key[:80]}")
    if others or not all(counts.values()):
        raise AssertionError(f"{reps} {n} inversions: device kernels other "
                             f"than the port's {others}, or one of the "
                             f"port's missing: {counts}")


# ---------------------------------------------------------------------------
# phase 3: the slice through prove / prove_many
# ---------------------------------------------------------------------------


def l2_circuit():
    from zelana_tpu_torch.circuits.l2_block import (
        L2BlockCircuit, compute_batch_hash, compute_state_root,
        compute_withdrawal_root)

    c = L2BlockCircuit.dummy()
    final = dict(c.initial_accounts)
    for t in c.transactions:
        final[t.sender_pk] -= t.amount
        final[t.recipient_pk] = final.get(t.recipient_pk, 0) + t.amount
    c.pre_state_root = compute_state_root(c.batch_id, c.initial_accounts)
    c.post_state_root = compute_state_root(c.batch_id, final)
    c.withdrawal_root = compute_withdrawal_root(c.withdrawals)
    c.batch_hash = compute_batch_hash(c.batch_id, c.transactions)
    return c


def phase_slice(torch, dev, report) -> dict:
    from zelana_tpu_torch.groth16.keys import ProvingKey
    from zelana_tpu_torch.groth16.prove import (prove, prove_many,
                                                public_inputs_of)
    from zelana_tpu_torch.groth16.verify import verify
    from zelana_tpu_torch.ops import cuda
    from zelana_tpu_torch.ops import ntt as NTT

    with open("zelana_tpu_torch/testdata/l2_dummy_proof.json") as f:
        want = json.load(f)
    t0 = time.time()
    pk = ProvingKey.load_npz("artifacts/l2_dummy_pk.npz")
    circuit = l2_circuit()
    pub = public_inputs_of(circuit)
    log(f"L2 key loaded + circuit built: {time.time() - t0:.2f} s")

    cuda.reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    first = prove(pk, circuit, batch_id=1)
    t1 = time.time()
    many = prove_many(pk, [(circuit, b) for b in (2, 3, 4, 5)])
    torch.cuda.synchronize()
    t2 = time.time()
    launches = {k: cuda.LAUNCHES[k] for k in SLICE_KERNELS}
    log(f"launches on the slice (5 proofs): {launches}")
    passes = 7 * len(NTT.default_split(13))
    if launches["ntt_pass"] != 5 * passes or launches["mont_mul"]:
        raise AssertionError(f"5 L2 proofs: {launches}, expected "
                             f"{5 * passes} ntt_pass (7 transforms x "
                             f"{passes // 7} passes) and no mont_mul")
    launches.pop("mont_mul")
    log(f"ntt_pass launches a prove: {launches['ntt_pass'] // 5}")

    proofs = [first] + many
    for i, p in enumerate(proofs):
        if not verify(pk.vk, p, pub):
            raise AssertionError(f"proof {i + 1} does not verify")
    blob = first.serialize_compressed().hex()
    if blob != want["proof"]:
        raise AssertionError("batch_id 1 proof differs from the recorded "
                             "JAX vector")
    if len({p.serialize_compressed() for p in proofs}) != len(proofs):
        raise AssertionError("distinct batch ids gave equal proofs")
    ms_first = (t1 - t0) * 1e3
    ms_many = (t2 - t1) * 1e3 / len(many)
    log(f"L2 prove (first, incl. key upload + NTT plan): {ms_first:.1f} ms")
    log(f"L2 prove_many x{len(many)}: {ms_many:.1f} ms/proof, "
        f"{1e3 / ms_many:.3f} proofs/s; 5 proofs verified, batch_id 1 "
        f"byte-equal to the JAX vector")
    report["l2"] = {"first_prove_ms": ms_first, "prove_many_ms_per_proof":
                    ms_many, "proofs_per_s": 1e3 / ms_many,
                    "launches": launches}
    if any(v == 0 for v in launches.values()):
        raise AssertionError(f"a kernel was not launched: {launches}")

    # where one prove's time goes: device busy time from the profiler's
    # kernel records against the host clock
    with profiled(torch) as prof:
        t0 = time.time()
        prove(pk, circuit, batch_id=6)
        torch.cuda.synchronize()
        wall = (time.time() - t0) * 1e3
    events = device_events(prof)
    busy = sum(e.self_device_time_total for e in events) / 1e3
    log(f"L2 prove under the profiler: {wall:.1f} ms wall, device busy "
        f"{busy:.2f} ms, idle share {1 - busy / wall:.4f}")
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    for e in top:
        log(f"  {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<5d} "
            f"{e.key[:70]}")
    report["l2"].update(profiled_wall_ms=wall, device_busy_ms=busy,
                        idle_share=1 - busy / wall)

    # and the host side of one prove: the port's functions by cumulative time
    import cProfile
    import pstats

    prof = cProfile.Profile()
    prof.runcall(prove, pk, circuit, batch_id=7)
    torch.cuda.synchronize()
    stats = pstats.Stats(prof).stats
    rows = sorted(((v[3], f"{os.path.basename(k[0])}:{k[2]}")
                   for k, v in stats.items() if "zelana_tpu_torch" in k[0]),
                  reverse=True)[:14]
    log("L2 prove, host functions by cumulative time (cProfile):")
    for cum, name in rows:
        log(f"  {cum * 1e3:9.1f} ms  {name}")
    return launches


# ---------------------------------------------------------------------------
# keygen against the committed seed-0 keys; the dryrun chunk's proof
# ---------------------------------------------------------------------------


def same_key(pk, path: str) -> None:
    """Raise unless pk's npz arrays equal those of the key at `path`."""
    import numpy as np

    got = pk.to_arrays()
    with np.load(path) as want:
        if sorted(got) != sorted(want.files):
            raise AssertionError(f"{path}: arrays {sorted(got)} against "
                                 f"{sorted(want.files)}")
        bad = [k for k in want.files if not np.array_equal(got[k], want[k])]
    if bad:
        raise AssertionError(f"keygen differs from {path} in {bad}")
    log(f"  key equal to {path}, array for array "
        f"({sum(len(v) for v in got.values())} rows)")


def dryrun_chunk():
    """The (1,0,1) depth-1 dryrun chunk: a transfer and a full shielded
    spend."""
    from zelana_tpu_torch.runtime.chunk_witness import ChunkWitnessBuilder
    from zelana_tpu_torch.runtime.coordinator import Dispatcher

    b = ChunkWitnessBuilder(1)
    b.fund(1, 100)  # depth-1 SMT: positions pk & 1
    b.fund(2, 0)
    note = b.add_note(spending_key=777, value=9, blinding=42)
    return Dispatcher.build_chunks_with_witness(
        b, [(1, 2, 10)], [], [("full", note, 777, 0xFACE, 9, 7)],
        capacity=(1, 0, 1), pre_shielded_root=b.shielded_root())[0]


def phase_keygen(report) -> None:
    from zelana_tpu_torch.circuits.l2_block import L2BlockCircuit
    from zelana_tpu_torch.groth16.prove import prove
    from zelana_tpu_torch.groth16.setup import keygen
    from zelana_tpu_torch.runtime.chunk_prover import (Groth16ChunkProver,
                                                       sunspot_proof_bytes)

    t0 = time.time()
    pk = keygen(L2BlockCircuit.dummy(), 0)
    t1 = time.time()
    log(f"keygen, L2 dummy circuit: {t1 - t0:.2f} s")
    same_key(pk, "artifacts/l2_dummy_pk.npz")
    t1 = time.time()
    prover = Groth16ChunkProver.setup((1, 0, 1), 1, 0)
    t2 = time.time()
    log(f"Groth16ChunkProver.setup((1, 0, 1), 1): {t2 - t1:.2f} s")
    same_key(prover.pk, "artifacts/chunk_101_d1_pk.npz")
    report["keygen"] = {"l2_dummy_s": t1 - t0, "chunk_101_d1_s": t2 - t1}

    with open("zelana_tpu_torch/testdata/chunk_101_d1_proof.json") as f:
        vec = json.load(f)
    chunk = dryrun_chunk()
    cp = prover.prove_chunk(chunk, vec["batch_id"])
    if cp.proof_bytes.hex() != vec["proof_bytes"]:
        raise AssertionError("dryrun chunk proof differs from the JAX vector")
    if [str(v) for v in cp.public_inputs] != vec["public_inputs"]:
        raise AssertionError("dryrun chunk public inputs differ")
    if not prover.verify_chunk(cp):
        raise AssertionError("dryrun chunk proof does not verify")
    t3 = time.time()
    dsl = prove(prover.pk, prover.build_circuit(chunk, vec["batch_id"]),
                batch_id=vec["batch_id"])
    t4 = time.time()
    if sunspot_proof_bytes(dsl) != cp.proof_bytes:
        raise AssertionError("prove_synthesized and the DSL prove differ on "
                             "the dryrun chunk")
    log(f"dryrun chunk: proof byte-equal to the JAX vector, verified; "
        f"DSL prove of the same chunk equal ({t4 - t3:.2f} s)")
    report["keygen"]["dsl_prove_101_s"] = t4 - t3


# ---------------------------------------------------------------------------
# phase 5: production chunk size, synthetic inputs
# ---------------------------------------------------------------------------


def phase_chunk(torch, dev, report) -> None:
    import numpy as np

    from zelana_tpu_torch.curves import g1 as G1, g2 as G2
    from zelana_tpu_torch.fields.bn254 import R as FR
    from zelana_tpu_torch.groth16.prove import witness_map
    from zelana_tpu_torch.ops import msm_scan as MSM
    from zelana_tpu_torch.ops import ntt as NTT

    rng = np.random.default_rng(21)
    t0 = time.time()
    plan = NTT.make_plan(CHUNK_DOMAIN)
    log(f"NTT plan 2^21 (host tables by running products): "
        f"{time.time() - t0:.2f} s")
    evals = [rand_words(torch, rng, FR >> 224, CHUNK_DOMAIN, dev)
             for _ in range(3)]
    before = [e.clone() for e in evals]
    h = witness_map(evals, plan)
    torch.cuda.synchronize()
    if not all(torch.equal(e, b) for e, b in zip(evals, before)):
        raise AssertionError("the 2^21 witness map wrote its inputs")
    del before
    wm_ms = cuda_ms(torch, lambda: witness_map(evals, plan), 3)
    t0 = time.time()
    h_plain = witness_map(evals, plan, plain=True)
    torch.cuda.synchronize()
    plain_s = time.time() - t0
    mism, _ = compare(torch, h, h_plain)
    log(f"witness map 2^21: {wm_ms:.2f} ms on the kernels, plain version "
        f"{plain_s:.1f} s; mismatches {mism}")
    if mism:
        raise AssertionError("2^21 witness map differs from its plain "
                             "version")
    report["witness_map_2_21_ms"] = wm_ms
    _witness_map_profile(torch, evals, plan, report)
    del h, h_plain, evals

    # MSMs at chunk size: pools tile P_j = (j+1) G, j < 4096, so the answer
    # is (sum_i s_i * ((i mod 4096) + 1) mod r) G
    tile = 4096
    for curve, n in (("g1", CHUNK_CONSTRAINTS), ("g1", CHUNK_DOMAIN - 1),
                     ("g2", CHUNK_CONSTRAINTS)):
        G = G1 if curve == "g1" else G2
        gen = G.generator()
        pts, acc = [], gen
        for _ in range(tile):
            pts.append(acc)
            acc = G.add(acc, gen)
        prep = (MSM.prepare_g1 if curve == "g1" else MSM.prepare_g2)(pts, dev)
        pool = prep[0].repeat(1, -(-n // tile))[:, :n].contiguous()
        limbs = rng.integers(0, 1 << 63, size=(n, 4), dtype=np.uint64)
        limbs[:, 3] >>= np.uint64(2)  # < 2^253 < r
        want = G.mul(gen, _tiled_scalar(limbs, tile) % FR)
        t0 = time.time()
        digits = MSM.scalar_digits(limbs)
        segs = MSM.build_segment_schedules(digits)
        MSM.upload_segment_schedules(segs, dev)
        torch.cuda.synchronize()
        t1 = time.time()
        got = MSM.msm_end(MSM.msm_begin_scheds(
            (pool, np.zeros(n, bool), curve), segs))
        t2 = time.time()
        log(f"MSM {curve} n={n}: schedules {1e3 * (t1 - t0):.0f} ms (host), "
            f"device + finish {1e3 * (t2 - t1):.1f} ms, "
            f"{len(segs)} segments; closed form {'ok' if got == want else 'WRONG'}")
        if got != want:
            raise AssertionError(f"{curve} MSM at n={n} is wrong")
        report[f"msm_{curve}_{n}_ms"] = 1e3 * (t2 - t1)
        report[f"msm_{curve}_{n}_sched_ms"] = 1e3 * (t1 - t0)
        if n == CHUNK_CONSTRAINTS:
            seg = slice(0, MSM.CHUNK_N)
            _segment_study(torch, pool[:, seg], digits[:, seg], curve, report)
        del pool, segs


def _witness_map_profile(torch, evals, plan, report, reps: int = 3) -> None:
    """`reps` 2^21 witness maps under torch.profiler (device_profile):
    device time per call and its bound; the run fails if any device kernel
    but ntt_pass_kernel ran (the scalings and the quotient are inside its
    passes), if a call launched other than 7 x default_split(21) passes,
    or if none of five windows held a pass kernel."""
    from zelana_tpu_torch.groth16.prove import witness_map
    from zelana_tpu_torch.ops import cuda
    from zelana_tpu_torch.ops import ntt as NTT

    log_n = plan.domain.log_size
    torch.cuda.synchronize()
    cuda.reset_launches()
    witness_map(evals, plan)
    torch.cuda.synchronize()
    launches = {k: v for k, v in cuda.LAUNCHES.items() if v}
    want = 7 * len(NTT.default_split(log_n))
    ms, _, events = device_profile(
        torch, lambda: witness_map(evals, plan), reps, kernels=want,
        tries=5)
    others = [e.key for e in events if "ntt_pass_kernel" not in e.key]
    count = sum(e.count for e in events if "ntt_pass_kernel" in e.key)
    products = witness_map_products(log_n)
    bms, by = bound_ms(32 * plan.n * 4, products * MUL_OPS)
    built = witness_map_products(log_n, built=True)
    report["witness_map_2_21_profile"] = {
        "device_ms": ms, "launches": launches, "kernels_seen": count,
        "others": others, "bound_ms": bms, "bound_by": by,
        "products": products, "built_products": built,
        "built_bound_ms": built * MUL_OPS / INT32_OPS_PER_S * 1e3}
    log(f"witness map 2^21 under the profiler, {reps} calls: {ms:.3f} ms of "
        f"device time a call, bound {bms:.3f} ms ({by}, {products} "
        f"products; the passes as built do {built}), {bms / ms:.1%} of it; "
        f"ntt_pass_kernel x{count}; launches a call {launches}; other "
        f"device kernels: {others or 'none'}")
    if (others or launches != {"ntt_pass": want} or not count
            or count > reps * want):
        raise AssertionError(f"2^21 witness map: device kernels other than "
                             f"ntt_pass_kernel {others}, or launches "
                             f"{launches} / {count} against {want} a call")


# the earlier stream shape (the JAX package's level-1 lanes, with 1,024
# level-2 lanes), timed beside the chosen one
OLD_LANES = {"g1": 8192, "g2": 2048}
SWEEP_LANES = (8192, 16384, 32768, 65536)
SWEEP_LANES2 = (1024, 2048, 4096, 8192)  # level-2 caps


def _segment_study(torch, pool, digits, curve, report) -> None:
    """One full 2^16-point segment of a chunk-size MSM: the lane sweep
    (whole-segment time of _device_msm per level-1 lane count and level-2
    cap), the kernel times at the earlier shapes and at the chosen ones, and
    the chosen level-1 pass against the plain version on the card."""
    from zelana_tpu_torch.ops import curve_kernels as CK
    from zelana_tpu_torch.ops import msm_scan as MSM

    dev = pool.device
    rep = report.setdefault("lane_sweep", {})[curve] = []
    for lanes in SWEEP_LANES:
        parts = MSM._bucket_partials(
            digits, MSM.level1_shape(digits.size, lanes)[1])
        for cap in SWEEP_LANES2:
            s = MSM.build_schedule(digits, lanes,
                                   MSM.level2_lanes(parts, cap))
            d = MSM._upload(s, dev)
            seg_ms = cuda_ms(torch, lambda: MSM._device_msm(pool, d, curve),
                             10)
            l1_ms = cuda_ms(torch, lambda: CK.runscan(pool, d["pid"],
                                                      d["flag"], curve), 10)
            row = {"lanes": lanes, "cap2": cap, "R": s.pid.shape[0] - 1,
                   "lanes2": s.pos2.shape[1], "R2": s.pos2.shape[0] - 1,
                   "K2": s.dense_idx.shape[0], "level1_ms": l1_ms,
                   "segment_ms": seg_ms}
            rep.append(row)
            log(f"  sweep {curve}: lanes {lanes} (R {row['R']}), level-2 cap "
                f"{cap} -> lanes2 {row['lanes2']} (R2 {row['R2']}, K2 "
                f"{row['K2']}): level 1 {l1_ms:.3f} ms, segment "
                f"{seg_ms:.3f} ms")
            del d
    earlier = MSM._upload(
        MSM.build_schedule(digits, OLD_LANES[curve], 1024), dev)
    d = MSM._upload(MSM.build_schedule(digits), dev)
    for tag, sched in (("earlier shape", earlier), ("chosen shape", d),
                       ("earlier shape, again", earlier)):
        _segment_kernels(torch, pool, sched, curve, report, tag)
    mism, err = compare(torch, CK.runscan(pool, d["pid"], d["flag"], curve),
                        CK.runscan_plain(pool, d["pid"], d["flag"], curve))
    log(f"  runscan {curve} level 1, full segment at the chosen shape "
        f"{tuple(d['flag'].shape)}, against the plain version: mismatches "
        f"{mism}, max |diff| {err}")
    C = CK.rows(curve)
    emit2 = CK.runscan(CK.runscan(pool, d["pid"], d["flag"], curve).view(
        C, -1), d["pos2"], d["flag2"], curve, True).view(C, -1)
    K = d["dense"].numel() // (MSM.SCAN_WINDOWS * MSM.SCAN_BUCKETS)
    mism2, err2 = compare(torch, CK.bucket_tail(emit2, d["dense"], K, curve),
                          CK.bucket_tail_plain(emit2, d["dense"], K, curve))
    log(f"  bucket_tail {curve}, full segment at the chosen shape (K {K}), "
        f"against the plain version: mismatches {mism2}, max |diff| {err2}")
    if mism or mism2:
        raise AssertionError(f"runscan / bucket_tail {curve}: the full "
                             f"segment differs from the plain version")


def _segment_kernels(torch, pool, d, curve, report, tag) -> None:
    """Kernel times on one full 2^16-point segment beside their bounds."""
    from zelana_tpu_torch.ops import curve_kernels as CK
    from zelana_tpu_torch.ops import msm_scan as MSM

    C = CK.rows(curve)
    rows1, lanes1 = d["flag"].shape
    rows2, lanes2 = d["flag2"].shape
    emit = CK.runscan(pool, d["pid"], d["flag"], curve)
    pool2 = emit.view(C, -1)
    emit2 = CK.runscan(pool2, d["pos2"], d["flag2"], curve, True).view(C, -1)
    K2 = d["dense"].numel() // (MSM.SCAN_WINDOWS * MSM.SCAN_BUCKETS)
    times = {}
    for part, name, fn, work in (
            ("level1", f"runscan {curve} level 1 ({rows1} x {lanes1})",
             lambda: CK.runscan(pool, d["pid"], d["flag"], curve),
             runscan_work(torch, pool, d["pid"], d["flag"], curve, False)),
            ("level2", f"runscan {curve} level 2 ({rows2} x {lanes2})",
             lambda: CK.runscan(pool2, d["pos2"], d["flag2"], curve, True),
             runscan_work(torch, pool2, d["pos2"], d["flag2"], curve, True)),
            ("tail", f"bucket_tail {curve} (K {K2})",
             lambda: CK.bucket_tail(emit2, d["dense"], K2, curve),
             tail_work(torch, emit2, d["dense"], K2, curve)),
            ("segment", f"segment {curve} (2 scans, {K2}-layer merge, tree)",
             lambda: MSM._device_msm(pool, d, curve), None)):
        ms = cuda_ms(torch, fn, 3)
        times[part] = ms
        key = f"{name}, {tag}"
        report[key] = {"ms": ms}
        if work:
            bms, by = bound_ms(*work)
            report[key].update(bound_ms=bms, bound_by=by)
        log(f"  {key}: {report[key]}")
    rest = times["segment"] - times["level1"] - times["level2"]
    report[f"segment {curve} less its two scans, {tag}"] = rest
    log(f"  segment {curve} less its two scans, {tag}: {rest:.4f} ms")


def _tiled_scalar(limbs, tile: int) -> int:
    """sum_i s_i * ((i mod tile) + 1) for (n, 4) uint64 limbs, exactly:
    per residue class, the 32-bit halves of each limb are summed in uint64
    (at most n / tile terms below 2^32 each)."""
    import numpy as np

    n = limbs.shape[0]
    pad = -n % tile
    halves = np.concatenate([limbs & np.uint64(0xFFFFFFFF),
                             limbs >> np.uint64(32)], axis=1)  # (n, 8)
    halves = np.concatenate([halves, np.zeros((pad, 8), np.uint64)])
    sums = halves.reshape(-1, tile, 8).sum(axis=0, dtype=np.uint64)
    total = 0
    for j in range(tile):
        lo, hi = sums[j, :4], sums[j, 4:]
        s = sum((int(lo[k]) + (int(hi[k]) << 32)) << (64 * k)
                for k in range(4))
        total += s * (j + 1)
    return total


# ---------------------------------------------------------------------------
# phase 6: the production chunk, keygen and two pipelined proves
# ---------------------------------------------------------------------------


def phase_production(torch, report) -> dict:
    """Returns the kernel launches of the production keygen."""
    from zelana_tpu_torch.groth16.keys import prepare_queries
    from zelana_tpu_torch.ops import cuda
    from zelana_tpu_torch.runtime.chunk_prover import Groth16ChunkProver
    from zelana_tpu_torch.runtime.chunk_witness import ChunkWitnessBuilder
    from zelana_tpu_torch.runtime.coordinator import Dispatcher
    from zelana_tpu_torch.trace import phase_log_start, phase_log_take

    cap, depth = PRODUCTION
    rep = report["production"] = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda.reset_launches()
    # under the profiler: its device busy time splits keygen's wall time
    # into device work and the host around it
    with profiled(torch) as prof:
        phase_log_start()
        t0 = time.time()
        prover = Groth16ChunkProver.setup(cap, depth, seed=0)
        torch.cuda.synchronize()
        rep["keygen_s"] = time.time() - t0
        launches = dict(cuda.LAUNCHES)
        rep["keygen_phases"] = _phases(phase_log_take(), t0)
    busy = _device_busy_ms(prof, "keygen")
    rep["keygen_device_busy_s"] = busy / 1e3
    rep["keygen_launches"] = launches
    rep["keygen_peak_bytes"] = torch.cuda.max_memory_allocated()
    pk = prover.pk
    log(f"production keygen ({cap}, depth {depth}): {rep['keygen_s']:.1f} s "
        f"wall, device busy {busy / 1e3:.3f} s, {len(pk.a_query)} "
        f"variables, h query {len(pk.h_query)}, launches {launches}, peak "
        f"device memory {rep['keygen_peak_bytes'] / 2**30:.2f} GiB")
    log(f"production keygen: {launches['step']} step launches (one per "
        f"chunk and curve)")
    if launches["step"] == 0:
        raise AssertionError("production keygen launched no step kernel")

    t0 = time.time()
    prepare_queries(pk, prover.device)
    torch.cuda.synchronize()
    rep["query_upload_s"] = time.time() - t0
    log(f"query pools encoded + uploaded: {rep['query_upload_s']:.2f} s")

    # a batch that fills two chunks: 16 transfers, 8 withdrawals and 8
    # shielded slots, the first a full-verification spend
    t0 = time.time()
    builder = ChunkWitnessBuilder(depth)
    for pk_i in range(1, 16):
        builder.fund(pk_i, 10_000)
    note = builder.add_note(spending_key=777, value=50, blinding=42)
    transfers = [(1 + (i % 8), 1 + ((i + 3) % 8), 10 + i)
                 for i in range(2 * cap[0])]
    withdrawals = [(1 + i, 0xAA00 + i, 5 + i) for i in range(2 * cap[1])]
    shielded = [("full", note, 777, 0xFACE, 50, 4242)] + [
        1000 + i for i in range(2 * cap[2] - 1)]
    chunks = Dispatcher.build_chunks_with_witness(
        builder, transfers, withdrawals, shielded, capacity=cap,
        pre_shielded_root=builder.shielded_root())
    if len(chunks) != 2:
        raise AssertionError(f"the batch made {len(chunks)} chunks, not 2")
    log(f"batch witnesses (depth-32 SMT paths, 2 chunks): "
        f"{time.time() - t0:.2f} s")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    cuda.reset_launches()
    t0 = time.time()
    cps = prover.prove_chunks(chunks, batch_id=7)
    torch.cuda.synchronize()
    rep["prove_chunks_s"] = time.time() - t0
    rep["prove_launches"] = dict(cuda.LAUNCHES)
    rep["prove_peak_bytes"] = torch.cuda.max_memory_allocated()
    rep["prove_peak_over_key_bytes"] = rep["prove_peak_bytes"] - base
    rep["chunk_ms"] = [cp.proving_time_ms for cp in cps]
    log(f"prove_chunks, 2 chunks: {rep['prove_chunks_s']:.2f} s; per chunk "
        f"{rep['chunk_ms']} ms (first, pipelined second); launches "
        f"{rep['prove_launches']}; peak device memory "
        f"{rep['prove_peak_bytes'] / 2**30:.2f} GiB "
        f"({rep['prove_peak_over_key_bytes'] / 2**30:.2f} GiB over the "
        f"resident key)")
    t0 = time.time()
    for cp in cps:
        if not prover.verify_chunk(cp):
            raise AssertionError(f"chunk {cp.chunk_index} does not verify")
    a, b = cps[0].public_inputs, cps[1].public_inputs
    if a[1] != b[0] or a[3] != b[2]:
        raise AssertionError("chunk roots do not chain")
    log(f"both chunk proofs verify ({time.time() - t0:.2f} s), roots chain")

    # one chunk prove under the profiler: device busy time against wall
    cuda.reset_launches()
    with profiled(torch) as prof:
        phase_log_start()
        t0 = time.time()
        again = prover.prove_chunk(chunks[0], batch_id=7)
        torch.cuda.synchronize()
        wall = (time.time() - t0) * 1e3
        phases = _phases(phase_log_take(), t0)
    if again.proof_bytes != cps[0].proof_bytes:
        raise AssertionError("prove_chunk and prove_chunks differ on chunk 0")
    one_launches = {k: v for k, v in cuda.LAUNCHES.items() if v}
    busy = _device_busy_ms(prof, "chunk prove")
    events = device_events(prof)
    scan = sum(e.self_device_time_total for e in events
               if "runscan_kernel" in e.key) / 1e3
    merge, tree = (sum(e.self_device_time_total for e in events
                       if k in e.key) / 1e3
                   for k in ("bucket_merge_kernel", "bucket_tree_kernel"))
    tail = merge + tree
    rep.update(profiled_wall_ms=wall, device_busy_ms=busy,
               idle_share=1 - busy / wall, prove_phases=phases,
               runscan_device_ms=scan, tail_device_ms=tail,
               tail_merge_ms=merge, tail_tree_ms=tree,
               chunk_prove_launches=one_launches)
    log(f"chunk prove under the profiler: {wall:.1f} ms wall, device busy "
        f"{busy:.1f} ms (run-scan {scan:.1f} ms, bucket tail {tail:.2f} ms: "
        f"merge {merge:.2f}, tree {tree:.2f}), "
        f"idle share {1 - busy / wall:.4f}; launches {one_launches}; equal "
        f"to the pipelined proof")
    ours = tuple(f"{k}_kernel" for k in cuda.LAUNCHES) + (
        "bucket_merge_kernel", "bucket_tree_kernel", "Memcpy", "Memset")
    torch_ops = sorted((e for e in events if e.self_device_time_total > 0
                        and not any(k in e.key for k in ours)),
                       key=lambda e: -e.self_device_time_total)
    rep["torch_device_ops"] = [(e.key[:90], e.count,
                                e.self_device_time_total / 1e3)
                               for e in torch_ops]
    log("chunk prove, torch kernels left on the device (copies, gathers, "
        "elementwise):")
    for e in torch_ops:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<6d} "
            f"{e.key[:90]}")
    _z_schedules(prover, chunks[0], rep)
    return launches


def _z_schedules(prover, chunk, rep) -> None:
    """R, R2 and K2 of the z schedules of one production chunk (the a, b1,
    l and b2 MSMs): the witness vector's digits are far from uniform."""
    from collections import Counter

    from zelana_tpu_torch.ops import msm_scan as MSM
    from zelana_tpu_torch.r1cs.native_synth import synthesize_chunk

    z = synthesize_chunk(prover.build_circuit(chunk, 7)).z
    segs = MSM.build_segment_schedules(MSM.scalar_digits(z))
    shapes = Counter(
        (s["sched"].pid.shape[0] - 1, s["sched"].pid.shape[1],
         s["sched"].pos2.shape[0] - 1, s["sched"].pos2.shape[1],
         s["sched"].dense_idx.shape[0]) for s in segs)
    rep["z_schedules"] = [dict(zip(("R", "lanes", "R2", "lanes2", "K2",
                                    "segments"), (*k, v)))
                          for k, v in sorted(shapes.items())]
    log(f"z schedules of one chunk ({len(segs)} segments), R x lanes, "
        f"R2 x lanes2, K2: " + "; ".join(
            f"{v} x ({R} x {l}, {R2} x {l2}, K2 {K2})"
            for (R, l, R2, l2, K2), v in sorted(shapes.items())))


def device_events(prof, empty_ok: bool = False) -> list:
    """The profile's device-side events (kernels, copies, sets). A host op
    (aten::copy_, aten::cat) carries the time of the kernels it launched
    as its own device time too, so summing every event counts those
    twice."""
    from torch.autograd import DeviceType

    events = [e for e in prof.key_averages()
              if e.device_type != DeviceType.CPU]
    if not events and not empty_ok:
        raise AssertionError("the profile holds no device events")
    return events


def _device_busy_ms(prof, what: str) -> float:
    """Sum of the device's self time over a profile's device events; logs
    the top kernels."""
    events = device_events(prof)
    log(f"{what}, device time by kernel:")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<6d} "
            f"{e.key[:70]}")
    every = sum(e.self_device_time_total for e in prof.key_averages()) / 1e3
    busy = sum(e.self_device_time_total for e in events) / 1e3
    log(f"{what}: device busy {busy:.3f} ms over device events; the sum "
        f"over all events, host ops included, is {every:.3f} ms")
    return busy


def _phases(entries, t0) -> list:
    """Log and return the (seconds since t0, label) of trace entries."""
    out = [(round(at - t0, 3), label) for at, _, label in entries]
    for at, label in out:
        log(f"  [+{at:8.3f} s] {label}")
    return out


if __name__ == "__main__":
    sys.exit(main())
