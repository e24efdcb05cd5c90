#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port of zelana-tpu on one card.

    python3 chip_smoke.py        # from the root of a checkout, one CUDA card
    python3 chip_smoke.py --phases kernels,keygen   # a subset, no result
    python3 chip_smoke.py --phases mesh   # the multi-card path alone
    python3 chip_smoke.py --phases production,msm24,mesh   # BASELINE config 5

Phases (any failure exits non-zero and prints no result):
  1. environment: card name and power limit, CUDA and nvcc versions, and the
     build of the kernels from zelana_tpu_torch/csrc (one nvcc per
     source, in parallel), with ptxas register and spill counts;
  2. `kernels`: each kernel against its plain PyTorch version on the card,
     exact equality: mont_mul (2^16 Fr, Fq and BLS12-381 Fr, with 0, 1 and
     p - 1; checked and timed, but launched on no path, so out of the
     kernels line); poseidon (BN254 8/56 and 8/57, BLS12-381 8/57, the
     permute mode and sponges over 1, 2, 3 and 5 columns at 2^12 and 4,097
     states, and the path's two-column BN254 8/56 sponge at 2^15, with 0, 1
     and p - 1; timed over two columns at 2^15, 2^12 and 2^20 beside its
     bound); ntt_pass,
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
     sampled outputs of each equal to the host hashes; launches (one
     poseidon launch a Poseidon hash and no mont_mul, asserted) and times;
     ten 2^15 Poseidon hashes under torch.profiler, no device kernel but
     poseidon_kernel allowed;
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
     and the chosen shape's two run-scans and bucket tail against their
     plain versions on the card;
  6. `engines`: the batch add jac_add (ops/curve_ops.py) against its
     plain version on the card at sharded_msm's (C, 1) once for each mask
     case of point_add, at 5 lanes and over 2^16 random points with the
     cases seeded in, timed at (C, 1) beside its bound; the Jacobian MSM's forms (jac_scan at offsets
     1, 128 and the chunk's last, a chunk's jac_reduce, jac_horner over 32
     windows) against their plain versions on the 2^16 MSM's own sorted
     digits, timed beside their bounds and, for the chains, their
     dependent Fq products; the tape
     MSM (ops/msm_fast.py) and the Jacobian MSM (ops/msm.py) on the edge
     inputs of tests/test_msm.py and at 2^16 points (one chunk segment),
     G1 and G2, equal to the closed form and to msm_scan; the step
     launches of each tape, split mixed / general, equal to its step
     counts, the point kernels' launches of each Jacobian MSM; each MSM
     under torch.profiler with no device kernel but its own and the
     listed torch copies, gathers and selects; times by CUDA events and
     device time beside their bounds, and a tape step's at S = 8,192;
  `services`: Groth16Prover.prove of the L2 dummy batch (batch 1)
     byte-equal to zelana_tpu_torch/testdata/l2_batch_proof.json and
     verified; OwnershipProver (seed-0 keygen, then the proof) equal to
     testdata/ownership_proof.json and verified;
  `shielded`: the shielded transfer (circuits/shielded.py: 2 inputs, 2
     outputs, depth 32; 19,005 variables, a 2^15 domain), built from the
     constants of zelana_tpu_torch/testdata/shielded_proof.json with the
     port's NoteTree: keygen(seed=0) (its SHA-256 and verifying key equal
     to the JAX package's, one step launch a fixed-base chunk, asserted),
     prove(batch_id=1) three times (byte-equal to the JAX proof, verified;
     the first and two warm proofs timed), the launches of a proof (21
     ntt_pass, two run-scans and a two-launch tail a segment, no mont_mul
     or poseidon) asserted against the plan and the schedules, K2 of the
     schedules at most K2_BOUND; the 2^15 witness map, the a query's two
     run-scans and bucket tail on the schedule the prove built, and the
     keygen's step rounds on its longest chunk of each curve against their
     plain versions on the card; a warm proof under torch.profiler (the
     fullest of up to three windows: busy time, idle share, each kernel's
     device time and launches kept beside its bound);
     the instance with fee + 1 refused on the host with no launch. The
     launches go to the kernels line as `shielded_launches`;
  7. `production`: Groth16ChunkProver.setup((8, 4, 4), 32) makes the
     production key (1,129,391 variables, 2^21 domain) with the step
     kernel (one launch per chunk and curve), then prove_chunks proves a
     batch of five chunks, the last half filled (valid slots 8/4/4 four
     times, then 4/2/2, as tools/prove_batch.py's batch on the TPU): every
     proof passes verify_chunk and the state and shielded roots chain
     across all five. Phase times of keygen, per-chunk prove times and
     launches, the run-scan and bucket-tail device time, busy time and idle
     share of one chunk prove (chunk 0, byte-equal to prove_chunks') under
     torch.profiler with the torch copy and gather kernels left on its
     device, the peak device memory, and R, R2 and K2 of the chunk's z
     schedules;
     With `mesh` too: the first chunk proved again through prove_chunks
     over a one-rank NCCL group (a file store, in this process), its proof
     byte-equal to the one-card proof, and merge_pairs (bucket_merge with
     K = 2) on the segment sums that run added up, G1 and G2 at width
     8,192, against bucket_merge_plain;
  `concurrent` (with `production`, on its key and proofs): (a) prove_chunk
     of chunks 1 and 2 on two threads at once; (b) two jobs (chunks [0, 1]
     and [2, 3]) submitted at once to one Dispatcher(prove_chunk), so two
     prove_chunks run at once; (c) the L2 dummy proof (batch 1) on a third
     thread while (b) runs. Every proof byte-equal to prove_chunks' (the
     roots chained within each job) or to
     zelana_tpu_torch/testdata/l2_dummy_proof.json, the launches equal
     kernel by kernel to the serial proves' sum; each run's wall time and
     peak device memory beside the same proves in a row, and (a) under
     torch.profiler for the idle share. A failure on any thread fails the
     run;
  `sequencer`: the sequencer served on the card through its HTTP API
     (sequencer/api.py start_api on port 0): the PipelineOrchestrator in
     GROTH16 mode, proving on its own thread with Groth16Prover over
     artifacts/l2_dummy_pk.npz and settling through
     OnchainVerifyingSettler, under PipelineService; POST /transfer and
     POST /dev/seal, then /status/stats until the batch settles; its proof
     and SubmitBatch instruction bytes, roots and balances equal to
     zelana_tpu_torch/testdata/pipeline_l2_proof.json (the JAX pipeline's).
     Then POST /v2/batch/prove of a batch that makes two production
     chunks (10 transfers, 5 withdrawals, 5 shielded commitments), the API's
     Dispatcher sending them over HTTP to the chunk worker
     (runtime/worker.py start_worker) with the production key (the
     `production` phase's prover, else made here), which proves both at
     once (asserted): both verify, their
     roots chain, and their bytes equal prove_chunks in-process; and POST
     /v2/ownership/prove equal to testdata/ownership_proof.json. The
     prover kernels' launches on the served paths go to the kernels line
     as `sequencer_launches`;
  `cli`: the command line (python -m zelana_tpu_torch.cli). In process,
     through cli.main: keygen --seed 0 (both files equal to the JAX
     command's digests in testdata/cli_vectors.json), prove --pk <that
     file> --batch-id 1 (equal to testdata/l2_dummy_proof.json), verify
     (every check True), test --zk (every line PASS; its key, proof and
     SubmitBatch equal to the JAX command's), deploy (the JAX descriptor),
     genkey (mode 0600); their launches of ntt_pass, runscan, bucket_tail
     and step go to the kernels line as `cli_launches`. As processes:
     worker --capacity 8/4/4 --depth 32 through SwarmController, which
     keygens itself and proves the served chunk job sent through
     Dispatcher(http_chunk_prover), byte-equal to prove_chunks in-process
     (the `production` phase's prover, else made here), its pid listed by
     nvidia-smi; three nodes and a NodeNetworkCoordinator proof; dev
     --ephemeral with ZL_PROVER_MODE=groth16 over the keygen's key, an
     airdrop against it, SIGINT: exit 0, and its shutdown batch refused
     on the host, not a kernel fault. Each command's seconds, the worker's
     start-up and the chunk job's proving_time_ms are logged beside the
     card;
  `msm24`: BASELINE config 5 on one card: the 2^24-point G1 MSM through
     msm_scan.msm_begin / msm_end (256 segments of 2^16) over the 4,096-point
     tile of P_j = (j + 1) G gathered on the card, uniform 253-bit scalars
     from a seed, equal to its closed form; its launches (two run-scans and
     a two-launch tail a segment, asserted), the host stages' seconds
     (digits, schedules, uploads, dispatch, the host's finish), device busy
     time under torch.profiler, peak device memory and peak RSS; the last
     segment's two run-scans and bucket tail against their plain versions;
  8. `mesh`: ntt_cross (the sharded NTT's cross-rank stage) against its
     plain version at 2^19 elements, both halves of the butterfly, with
     and without the final 1/n, timed beside its bound; then four ranks
     spawned drive the multi-card path, over NCCL with a card a rank where
     the host has four cards, else over gloo on the one card (the
     exchanged arrays through host memory; NCCL refuses two ranks on one
     card): sharded_msm_scan at 4 x 2^16 points, G1 and G2, against the
     closed form; sharded_ntt / sharded_intt at 2^21 against the one-card
     NTT; sharded_mimc_hash2 at 2^20 against hash2_batch; sharded_msm at
     4 x 2^12 against the closed form; the chunk prover's prove_chunk of
     the dryrun chunk through the mesh, byte-equal to
     zelana_tpu_torch/testdata/chunk_101_d1_proof.json. Each rank's times,
     its collectives' host time and its device busy time (torch.profiler)
     are logged; the ranks' ntt_cross launches go to the kernels line.
     After the path, merge_pairs against bucket_merge_plain on the arrays
     the ranks exchanged in the reduction (widths 4,096 and 2,048, G1 and
     G2) and on the two 8,192-wide orders of each first pair. Then, each
     in its own run_local call over the same backend: the 2^24-point G1 MSM
     over the four ranks through msm_begin_sharded (2^22 points and 64
     segments a rank, added up on the card, then two exchanges), every
     rank equal to the closed form, merge_pairs held at 8,192, 4,096 and
     2,048, rank 0's last segment held as in `msm24`; and, with
     `production`, its first chunk proved over the four ranks through
     prove_chunks (the key handed over by ProvingKey.save_npz in a
     temporary directory), every rank's proof byte-equal to the one-card
     proof and verified, merge_pairs held in G1 and G2. Launches asserted
     per rank, times, device busy time, peak device memory and peak RSS a
     rank;
  9. one JSON line of per-kernel numbers (launches: the prover's kernels
     on the L2 slice, step on the production keygen and, apart, on the
     tape MSMs, jac_scan / jac_reduce / jac_horner on the Jacobian MSMs,
     jac_add on the mesh path's sharded_msm, mimc_permute
     and poseidon on the hashes, inv_fwd / inv_bwd /
     inv_base on the inversions, ntt_cross on the mesh path; beside them
     the served, command-line and shielded paths' launches and those of
     BASELINE config 5: `msm_2_24_launches` on one card,
     `mesh_msm_2_24_launches` and `mesh_chunk_launches` summed over the
     ranks), the card, the result line.

Each phase's wall seconds are logged as it ends.

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
import threading
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
# 32-bit integer multiply(-add) issue rate: 132 SMs x 64 INT32 lanes x
# 1.98 GHz boost (Hopper SM layout); the data sheet gives no int32 rate
INT32_OPS_PER_S = 132 * 64 * 1.98e9
MUL_OPS = 2 * 2 * 8 * 8 + 8  # one 8x32-bit CIOS: 128 wide products, 8 m's
SQR_OPS = 2 * 36 + 2 * 8 * 8 + 8  # a squaring: 36 distinct word products

CHUNK_CONSTRAINTS = 1_128_532  # the 8/4/4 production chunk
CHUNK_DOMAIN = 1 << 21
PRODUCTION = ((8, 4, 4), 32)  # capacity and tree depth of the chunk
PHASES = ("kernels", "hashes", "inversion", "slice", "keygen", "chunk",
          "engines", "services", "shielded", "production", "concurrent",
          "sequencer", "cli", "msm24", "mesh")
SLICE_KERNELS = ("ntt_pass", "runscan", "bucket_tail", "mont_mul")


def log(*a):
    print(*a, flush=True)


def phase_clock(report):
    """A context manager a phase: `with clock(name):` logs the phase's
    wall seconds and keeps them in report["phase_s"]."""
    spent = report.setdefault("phase_s", {})

    @contextlib.contextmanager
    def clock(name: str):
        t0 = time.time()
        yield
        spent[name] = time.time() - t0
        log(f"phase {name}: {spent[name]:.1f} s wall")

    return clock


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES)
                    + "; a subset prints no result line")
    args = ap.parse_args()
    phases = args.phases.split(",")
    if set(phases) - set(PHASES):
        ap.error(f"unknown phase in {phases}")
    if "concurrent" in phases and "production" not in phases:
        ap.error("the concurrent phase runs on the production phase's key "
                 "and proofs: name both")
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
    kernels, launches, paths = [], {}, {}
    clock = phase_clock(report)
    if "kernels" in phases:
        with clock("kernels"):
            kernels = phase_kernels(torch, dev, report)
    if "hashes" in phases:
        with clock("hashes"):
            launches.update(phase_hashes(torch, dev, report))
    if "inversion" in phases:
        with clock("inversion"):
            launches.update(phase_inversion(torch, dev, report))
    if "slice" in phases:
        with clock("slice"):
            launches.update(phase_slice(torch, dev, report))
    if "keygen" in phases:
        with clock("keygen"):
            phase_keygen(report)
    if "chunk" in phases:
        with clock("chunk"):
            phase_chunk(torch, dev, report)
    tape = {}
    if "engines" in phases:
        with clock("engines"):
            entries, eng_launches, tape_runs, step_times = phase_engines(
                torch, dev, report)
        kernels += entries
        launches.update(eng_launches)
        tape = {"tape_launches": tape_runs, "tape_steps": step_times}
    if "services" in phases:
        with clock("services"):
            phase_services(torch, dev, report)
    if "shielded" in phases:
        with clock("shielded"):
            # a shielded proof's, step the keygen's
            paths["shielded_launches"] = phase_shielded(torch, dev, report)
    chunk_prover, production = None, None
    if "production" in phases:
        with clock("production"):
            # step's launches come from the production keygen
            keygen, chunk_prover, batch = phase_production(
                torch, report, "mesh" in phases)
        launches["step"] = keygen["step"]
        production = (chunk_prover, batch)
    if "concurrent" in phases:
        with clock("concurrent"):
            phase_concurrent(torch, report, chunk_prover, batch)
    if "sequencer" in phases:
        with clock("sequencer"):
            # and on the sequencer's served paths
            paths["sequencer_launches"] = phase_sequencer(torch, report,
                                                          chunk_prover)
    if "cli" in phases:
        with clock("cli"):
            # and on the command line's in-process runs
            paths["cli_launches"] = phase_cli(torch, report, card,
                                              chunk_prover)
    if "msm24" in phases:
        with clock("msm24"):
            paths["msm_2_24_launches"] = phase_msm24(torch, dev, report)
    if "mesh" in phases:
        with clock("mesh"):
            entry, mesh_launches, mesh_paths = phase_mesh(torch, dev, report,
                                                          production)
        kernels.append(entry)
        launches.update(mesh_launches)
        paths.update(mesh_paths)
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
        if k["name"] == "step":  # and its launches on the tape MSMs
            k.update(tape)
        for field, counts in paths.items():  # and on the later paths
            if k["name"] in counts:
                k[field] = counts[k["name"]]
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
    bms, by = bound_ms(2 * n * 96, 2 * n * MUL_OPS)
    # no path launches mont_mul: the products that reach
    # pallas_field._mont_mul_call on a TPU run inside the poseidon, ntt_pass
    # and ntt_cross kernels, whose entries carry them; its checks and times
    # stay here, out of the kernels line
    report["mont_mul"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain,
                          "bound_ms": bms, "bound_by": by}
    log(f"  mont_mul 2^16 Fr + Fq: {ms:.4f} ms, {plain:.3f} ms plain, bound "
        f"{bms:.4f} ms ({by}); launched on no path")

    kernels.append(_poseidon_kernel(torch, dev, rng, check, report))
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
        nbytes, ops = step_work(n, curve)
        out["bytes"] += nbytes
        out["ops"] += ops
        del pool, got, want, work
    out["bound_ms"], out["bound_by"] = bound_ms(out["bytes"], out["ops"])
    log(f"  step, one keygen chunk, G1 + G2: {out['ms']:.4f} ms kernel, "
        f"{out['plain']:.1f} ms plain, bound {out['bound_ms']:.4f} ms "
        f"({out['bound_by']})")
    return out


def step_work(n: int, curve: str) -> tuple:
    """(bytes, int32 operations) of keygen's five step rounds on n scalars:
    the table head read once, the two id arrays, the n sums written, and 12
    (G1) or 42 (G2) Montgomery products for each of the 31 n adds."""
    from zelana_tpu_torch.ops import fixed_base as FB

    C = 24 if curve == "g1" else 48
    S = n * FB.N_WINDOWS // 2
    muls = 12 if curve == "g1" else 42
    return ((FB.N_TABLE + 1) * C * 4 + 2 * S * 4 + n * C * 4,
            (2 * S - n) * muls * MUL_OPS)  # S + S/2 + ... + n adds


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


POSEIDON_CFGS = (("BN254 8/56", "bn254_config"),
                 ("BN254 8/57", "bn254_config_57"),
                 ("BLS12-381 8/57", "bls12_381_config"))


def poseidon_products(cfg) -> int:
    """Montgomery products of one permutation as the rounds are written: a
    full round three s-boxes of three products and the 9 MDS products, a
    partial round one s-box and the 9 (816 at 8/56, 828 at 8/57)."""
    return 18 * cfg.full_rounds + 12 * cfg.partial_rounds


def poseidon_least_ops(cfg) -> int:
    """int32 operations of the fewest products a two-column hash needs
    (one permutation from a zero capacity lane; lane 1 out), with the same
    output: a full round's three s-boxes (two squarings and a product
    each) and its dense 9-product MDS; a partial round in the sparse-MDS
    form (the Poseidon paper's appendix B): one s-box and 2 x 3 - 1 = 5
    products, the dense rest folded into the full round before; no s-box
    for the first round's lane 0 (a constant); the last MDS three
    products (lane 1 alone). A squaring costs SQR_OPS, a product MUL_OPS:
    158 squarings and 425 products at 8/56 (0.67 of the written form's
    operations)."""
    squarings = 2 * (3 * cfg.full_rounds + cfg.partial_rounds) - 2
    products = 12 * cfg.full_rounds + 6 * cfg.partial_rounds - 1 - 6
    return squarings * SQR_OPS + products * MUL_OPS


def poseidon_work(cfg, n: int, least: bool = True):
    """(bytes, int32 operations) of a two-column Poseidon hash of n states:
    two columns read and one written, the constants read once; the
    operations poseidon_least_ops's, or (least=False) the written form's
    poseidon_products x MUL_OPS."""
    from zelana_tpu_torch.ops import field_kernels as FK

    rows = FK.poseidon_rows(cfg.full_rounds, cfg.partial_rounds)
    ops = (poseidon_least_ops(cfg) if least
           else poseidon_products(cfg) * MUL_OPS)
    return 32 * 3 * n + 32 * rows, ops * n


def _poseidon_kernel(torch, dev, rng, check, report) -> dict:
    """poseidon_kernel against its plain versions on the card, whole
    outputs: the three configurations, the permute mode and sponges over
    1, 2, 3 and 5 columns, at 2^12 and a ragged 4,097 states with 0, 1 and
    p - 1 among the inputs (the plain versions run once at 4,097; the
    2^12 outputs hold to their first 4,096 states). Timed over two
    columns (the hashes path's) at 2^15 (8/56, PERF.md's hashes/s
    metric; there also held whole to the plain run that is timed), 2^12
    (8/57, both fields) and 2^20 (8/56), by CUDA events and by device
    time, beside the bound of the fewest operations (bound_ms) and that of
    the rounds as written (written_bound_ms)."""
    from zelana_tpu_torch.hashes import poseidon as P
    from zelana_tpu_torch.hashes import poseidon_batch as PB
    from zelana_tpu_torch.ops import field_kernels as FK
    from zelana_tpu_torch.ops import limbs as L

    rep = report["poseidon"] = {}
    err, wide = 0, 4097
    for name, fn in POSEIDON_CFGS:
        cfg = getattr(P, fn)()
        spec = L.FieldSpec(cfg.modulus)
        args = (PB._device_tables(cfg, dev), cfg.full_rounds,
                cfg.partial_rounds, spec)
        edge = L.to_tensor(L.to_words([0, 1, spec.modulus - 1]), dev)
        cols = [rand_words(torch, rng, spec.modulus >> 224, wide, dev)
                for _ in range(5)]
        for c in cols:
            c[:, :3] = edge
        state = torch.stack(cols[2:])
        for k in (0, 1, 2, 3, 5):
            if k == 0:
                want = FK.poseidon_permute_plain(state, *args)
            else:
                want = FK.poseidon_sponge_plain(cols[:k], *args)
            for n in (1 << 12, wide):
                if k == 0:
                    got = FK.poseidon_permute(
                        state[:, :, :n].contiguous(), *args)
                else:
                    got = FK.poseidon_sponge(
                        [c[:, :n].contiguous() for c in cols[:k]], *args)
                err = max(err, check(
                    f"poseidon {name} {'permute' if k == 0 else f'{k} cols'}"
                    f" n {n}", got, want[..., :n]))
    times = {}
    for label, fn, n in (("8/56 2^15", "bn254_config", 1 << 15),
                         ("8/57 2^12 BN254", "bn254_config_57", 1 << 12),
                         ("8/57 2^12 BLS12-381", "bls12_381_config", 1 << 12),
                         ("8/56 2^20", "bn254_config", 1 << 20)):
        cfg = getattr(P, fn)()
        spec = L.FieldSpec(cfg.modulus)
        args = (PB._device_tables(cfg, dev), cfg.full_rounds,
                cfg.partial_rounds, spec)
        edge = L.to_tensor(L.to_words([0, 1, spec.modulus - 1]), dev)
        cols = [rand_words(torch, rng, spec.modulus >> 224, n, dev)
                for _ in range(2)]
        cols[0][:, :3] = edge
        cols[1][:, 3:6] = edge
        bms, by = bound_ms(*poseidon_work(cfg, n))
        written = bound_ms(*poseidon_work(cfg, n, least=False))[0]
        t = {"ms": cuda_ms(torch, lambda: FK.poseidon_sponge(cols, *args),
                           20),
             "device_ms": device_ms(torch, lambda: FK.poseidon_sponge(
                 cols, *args), 20, 1),
             "bound_ms": bms, "bound_by": by, "written_bound_ms": written}
        if label == "8/56 2^15":
            plain = []
            t["plain_ms"] = cuda_ms(torch, lambda: plain.append(
                FK.poseidon_sponge_plain(cols, *args)), 1, False)
            err = max(err, check(f"poseidon {label} 2 cols (the path's)",
                                 FK.poseidon_sponge(cols, *args), plain[0]))
        t["share_of_bound"] = bms / t["device_ms"]
        t["share_of_written_bound"] = written / t["device_ms"]
        times[label] = t
        log(f"  poseidon {label}, 2 cols: {t['ms']:.4f} ms by events, "
            f"{t['device_ms']:.4f} ms device time, bound {bms:.4f} ms "
            f"({by}, {t['share_of_bound']:.0%}; the rounds as written "
            f"{written:.4f} ms, {t['share_of_written_bound']:.0%})")
    rep.update(times)
    main = times["8/56 2^15"]
    entry = _entry("poseidon", "zelana_tpu_torch/csrc/field_kernels.cu",
                   "zelana_tpu/hashes/poseidon_jax.py:49 (on a TPU "
                   "pallas_field.py:136 per product)", err, main["ms"],
                   main["plain_ms"], main["bound_ms"], main["bound_by"])
    entry["device_ms"] = main["device_ms"]
    entry["written_bound_ms"] = main["written_bound_ms"]
    entry["other_shapes"] = {k: {"ms": v["ms"], "device_ms": v["device_ms"],
                                 "bound_ms": v["bound_ms"],
                                 "written_bound_ms": v["written_bound_ms"]}
                             for k, v in times.items() if k != "8/56 2^15"}
    return entry


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
    path = {k: cuda.LAUNCHES[k] for k in ("mimc_permute", "poseidon")}
    log(f"launches on the hashing path: {dict(cuda.LAUNCHES)}")
    # a Poseidon hash is one launch: every round of every permutation in
    # the kernel, no mont_mul and no torch op around it
    for name, _, _, _, _ in runs:
        if name.startswith("poseidon") and launches[name] != {"poseidon": 1}:
            raise AssertionError(f"{name}: launches {launches[name]}, "
                                 f"expected one poseidon launch")
    if cuda.LAUNCHES["mont_mul"]:
        raise AssertionError(f"the hashing path launched mont_mul "
                             f"{cuda.LAUNCHES['mont_mul']} times")

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
    _poseidon_profile(torch, next(fn for name, fn, *_ in runs
                                  if name.startswith("poseidon bn254 8/56")),
                      rep)
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


def _poseidon_profile(torch, fn, rep, reps: int = 10) -> None:
    """`reps` runs of fn (the 2^15 BN254 8/56 Poseidon hash) back to back
    under torch.profiler; the run fails if any device kernel but
    poseidon_kernel ran (a window that shows none of it is profiled again,
    up to five times)."""
    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profiled(torch) as prof:
            for _ in range(reps):
                fn()
        events = device_events(prof, empty_ok=True)
        ours = [e for e in events if "poseidon_kernel" in e.key]
        if ours:
            break
    others = [e.key for e in events if "poseidon_kernel" not in e.key]
    seen = sum(e.count for e in ours)
    per = sum(e.self_device_time_total for e in ours) / 1e3 / max(seen, 1)
    rep["profile poseidon 8/56 2^15"] = {
        "hashes": reps, "kernels_seen": seen, "per_hash_ms": per,
        "others": others}
    log(f"  {reps} Poseidon 8/56 2^15 hashes under the profiler: "
        f"poseidon_kernel x{seen}, {per:.4f} ms of device time a hash; "
        f"other device kernels: {others or 'none'}")
    if others or not seen:
        raise AssertionError(f"Poseidon hash: device kernels other than "
                             f"poseidon_kernel {others}, or none of it "
                             f"seen ({seen})")


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
    for curve, n in (("g1", CHUNK_CONSTRAINTS), ("g1", CHUNK_DOMAIN - 1),
                     ("g2", CHUNK_CONSTRAINTS)):
        pool, limbs, want = tiled_msm(torch, curve, n, rng, dev)
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
    the chosen shape's two run-scans and bucket tail against their plain
    versions on the card (hold_segment)."""
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
    hold_segment(torch, pool, d, curve, "full segment, chosen shape")


def hold_segment(torch, pool, d, curve: str, what: str) -> int:
    """One segment of an MSM held on the card: on `d`, its uploaded
    schedule, the level-1 and level-2 run-scans and the bucket tail against
    their plain versions, each on the kernel's own inputs; raises on any
    difference. Returns the max |diff|."""
    from zelana_tpu_torch.ops import curve_kernels as CK

    C = CK.rows(curve)
    emit = CK.runscan(pool, d["pid"], d["flag"], curve)
    pool2 = emit.view(C, -1)
    emit2 = CK.runscan(pool2, d["pos2"], d["flag2"], curve, True)
    K = d["dense"].numel() // CK.NB
    tail = CK.bucket_tail(emit2.view(C, -1), d["dense"], K, curve)
    err = 0
    for name, got, plain in (
            (f"runscan level 1 {tuple(d['flag'].shape)}", emit,
             lambda: CK.runscan_plain(pool, d["pid"], d["flag"], curve)),
            (f"runscan level 2 {tuple(d['flag2'].shape)}", emit2,
             lambda: CK.runscan_plain(pool2, d["pos2"], d["flag2"], curve,
                                      True)),
            (f"bucket_tail (K {K})", tail,
             lambda: CK.bucket_tail_plain(emit2.view(C, -1), d["dense"], K,
                                          curve))):
        mism, diff = compare(torch, got, plain())
        log(f"  {what}: {name} {curve} against the plain version: "
            f"mismatches {mism}, max |diff| {diff}")
        if mism:
            raise AssertionError(f"{what}: {name} {curve} differs from its "
                                 f"plain version")
        err = max(err, diff)
    return err


def segment_schedule(limbs, dev) -> dict:
    """The uploaded schedule of one segment of at most 2^16 scalars."""
    from zelana_tpu_torch.ops import msm_scan as MSM

    return MSM._upload(MSM.build_schedule(MSM.scalar_digits(limbs)), dev)


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


MSM_TILE = 4096


@functools.lru_cache(maxsize=None)
def _tile_points(curve: str) -> list:
    """P_j = (j + 1) G for j < MSM_TILE."""
    from zelana_tpu_torch.curves import g1 as G1, g2 as G2

    G = G1 if curve == "g1" else G2
    gen = G.generator()
    pts, acc = [], gen
    for _ in range(MSM_TILE):
        pts.append(acc)
        acc = G.add(acc, gen)
    return pts


def tiled_pool(torch, curve: str, lo: int, hi: int, dev):
    """Columns [lo, hi) of the (VC, n) pool that tiles P_j = (j + 1) G,
    j < MSM_TILE: the tile encoded once and gathered on the card, never a
    host list of n points."""
    from zelana_tpu_torch.ops import msm_scan as MSM

    tile = (MSM.prepare_g1 if curve == "g1" else MSM.prepare_g2)(
        _tile_points(curve), dev)[0]
    cols = torch.arange(lo, hi, device=dev) % MSM_TILE
    return tile.index_select(1, cols)


def scalar_limbs(rng, n: int):
    """(n, 4) uint64 limbs of uniform scalars below 2^253 (< r)."""
    import numpy as np

    limbs = rng.integers(0, 1 << 63, size=(n, 4), dtype=np.uint64)
    limbs[:, 3] >>= np.uint64(2)
    return limbs


def tiled_want(curve: str, limbs):
    """The closed form of the MSM of `limbs` over the tiled pool:
    (sum_i s_i ((i mod MSM_TILE) + 1) mod r) G."""
    from zelana_tpu_torch.curves import g1 as G1, g2 as G2
    from zelana_tpu_torch.fields.bn254 import R as FR

    G = G1 if curve == "g1" else G2
    return G.mul(G.generator(), _tiled_scalar(limbs, MSM_TILE) % FR)


def tiled_msm(torch, curve: str, n: int, rng, dev):
    """An MSM with a closed-form answer: (pool, scalar limbs, result) over
    the tiled pool (tiled_pool, tiled_want); scalars below 2^253."""
    limbs = scalar_limbs(rng, n)
    return (tiled_pool(torch, curve, 0, n, dev), limbs,
            tiled_want(curve, limbs))


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
# `engines`: the tape MSM and the Jacobian windowed MSM at one chunk
# segment's width; `services`: the prover's service entry points
# ---------------------------------------------------------------------------

# int32 operations of a Jacobian point op on general inputs: an add
# (add-2007-bl) 12 products and 4 squarings, a doubling (dbl-2009-l) 2 and
# 5; over Fq a product MUL_OPS and a squaring SQR_OPS, over Fq2 a product
# 3 Fq products (Karatsuba) and a squaring 2 (complex squaring), MUL_OPS
# each
JAC_ADD_OPS = {"g1": 12 * MUL_OPS + 4 * SQR_OPS,
               "g2": (12 * 3 + 4 * 2) * MUL_OPS}
JAC_DBL_OPS = {"g1": 2 * MUL_OPS + 5 * SQR_OPS,
               "g2": (2 * 3 + 5 * 2) * MUL_OPS}
# Montgomery products of a tape step's mixed add 9 Fq / 10 Fq2 (mul_b3 of
# G2 one Fq2 product), of its complete add 12 / 14 (RUNSCAN_MULS)
# dependent products of the cooperative add and doubling (jac_kernels.cu:
# product stages, a product a member a stage on the chains' teams)
JAC_ADD_STAGES, JAC_DBL_STAGES = 5, 3
STEP_FQ = {("g1", True): 9, ("g1", False): 12, ("g2", True): 30,
           ("g2", False): 42}
JAC_CHECK_N = 1 << 16  # points of the mask-case checks
JAC_FORMS = ("jac_scan", "jac_reduce", "jac_horner")
# device kernels each MSM may run beside its own: copies and fills of the
# pool, the uploads and the finals' gather (tape); the points' gather, the
# Z = one fill and the uploads of their order, run positions and run ends
# (Jacobian)
TAPE_KERNELS = ("step_kernel", "Memcpy", "Memset", "copy", "Fill", "index",
                "scatter_gather")
JAC_KERNELS = ("jac_scan_kernel", "jac_reduce_kernel", "jac_horner_kernel",
               "Memcpy", "Memset", "copy", "Fill", "index", "scatter_gather")


def _only_kernels(events, allowed, what: str) -> None:
    names = {e.key: e.count for e in events}
    log(f"  {what}: device kernels (launches, ms of the window) "
        + json.dumps({k[:70]: [e.count, e.self_device_time_total / 1e3]
                      for k, e in zip(names, events)}))
    bad = [k for k in names if not any(a in k for a in allowed)]
    if bad:
        raise AssertionError(f"{what} ran device kernels outside "
                             f"{allowed}: {bad}")


def _tape_work(tape, curve: str):
    """(bytes, int32 operations, mixed pairs, general pairs) of a tape
    MSM's device part: the affine points read once, the tape's ids, the 256
    sums written; the adds of its real pairs (padding pairs read slot 0
    twice)."""
    C, n = (24 if curve == "g1" else 48), tape.n_points
    real = tape.idx[:, 0] != 0  # (steps, S)
    mixed = int(real[:tape.mixed_steps].sum())
    general = int(real[tape.mixed_steps:].sum())
    nbytes = 4 * (2 * C // 3 * n + tape.idx.size + C * 256)
    ops = (mixed * STEP_FQ[(curve, True)]
           + general * STEP_FQ[(curve, False)]) * MUL_OPS
    return nbytes, ops, mixed, general


def _reduce_adds(ends) -> int:
    """The bucket reductions' adds that the data needs, from (W, 256) run
    ends: running += S_d adds where both are points, from the second
    nonempty bucket down (buckets - 1 a window), total += running below the
    highest nonempty bucket (its digit - 1); the rest meet an identity."""
    import numpy as np

    full = ends[:, 1:] >= 0
    top = np.where(full.any(axis=1), full.shape[1] - np.argmax(
        full[:, ::-1], axis=1), 0)
    return int(np.maximum(full.sum(axis=1) - 1, 0).sum()
               + np.maximum(top - 1, 0).sum())


def _jac_msm_work(digits, curve: str):
    """(bytes, int32 operations) of a Jacobian MSM: the affine points read
    once, the sort order and run positions (int32) and run ends uploaded,
    the result written; the adds that the data needs: the scan's (a lane
    of a nonzero digit adds at each step 2^k <= its run position:
    bit_length(pos) adds; digit 0's lanes none), the bucket reductions'
    (_reduce_adds), the Horner's 31 adds and 248 doublings."""
    import numpy as np

    from zelana_tpu_torch.ops import msm as JM

    C = 24 if curve == "g1" else 48
    w, n = digits.shape
    chunk = JM._window_chunk(n)
    adds = 0
    for w0 in range(0, w, chunk):
        pos, ends, _ = JM.scan_plan(digits[w0:w0 + chunk])
        adds += int(np.frexp(np.maximum(pos, 0))[1].sum()) + _reduce_adds(ends)
    adds += w - 1
    dbls = JM.WINDOW_BITS * (w - 1)
    nbytes = 4 * (2 * C // 3 * n + 2 * w * n + JM.N_BUCKETS * w + C)
    return nbytes, adds * JAC_ADD_OPS[curve] + dbls * JAC_DBL_OPS[curve]


def _jac_add_checks(torch, dev, rng, check, report) -> dict:
    """The batch add (jac_add) against its plain version on the card: at
    the shape of its one path, sharded_msm's combine of the ranks' (C, 1)
    sums, once for each of point_add's mask cases; at 5 lanes (part of a
    block) and at JAC_CHECK_N lanes (whole blocks) with the cases seeded
    in. Timed at (C, 1), a general add, by device time beside its bound.
    Returns its kernels-line numbers, G1 + G2."""
    from zelana_tpu_torch.ops import curve_kernels as CK
    from zelana_tpu_torch.ops import curve_ops as CO
    from zelana_tpu_torch.ops import limbs as L

    a = {"err": 0, "ms": 0.0, "plain": 0.0, "bytes": 0.0, "ops": 0.0}
    n = JAC_CHECK_N
    for curve in ("g1", "g2"):
        C = CK.rows(curve)
        rep = report.setdefault(curve, {})

        def words(k):
            return torch.cat([rand_words(torch, rng, L.FQ.modulus >> 224, k,
                                         dev) for _ in range(C // 8)])

        p, q = CO.seed_mask_cases(words(n), words(n), words(n)[:C // 3],
                                  curve)
        a["err"] = max(a["err"], check(
            f"jac_add {curve} {n}, every mask case", CO.jac_add(p, q, curve),
            CO.jac_add_plain(p, q, curve)))
        cols = [(f"(C, 1) {case}", k, k + 1)
                for k, case in enumerate(CO.MASK_CASES)]
        for what, lo, hi in cols + [("5 lanes", 0, 5)]:
            p1, q1 = p[:, lo:hi].contiguous(), q[:, lo:hi].contiguous()
            a["err"] = max(a["err"], check(
                f"jac_add {curve} {what}", CO.jac_add(p1, q1, curve),
                CO.jac_add_plain(p1, q1, curve)))
        p1, q1 = p[:, :1].contiguous(), q[:, :1].contiguous()  # general
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(3):
            CO.jac_add_plain(p1, q1, curve)
        torch.cuda.synchronize()
        plain = 1e3 * (time.time() - t0) / 3
        ms = device_ms(torch, lambda: CO.jac_add(p1, q1, curve), 20, 1)
        work = (3 * C * 4, JAC_ADD_OPS[curve])
        rep["jac_add_combine"] = {"device_ms": ms, "plain_ms": plain,
                                  "bound_ms": bound_ms(*work)[0],
                                  "bound_by": bound_ms(*work)[1]}
        for k, v in zip(("ms", "plain", "bytes", "ops"), (ms, plain) + work):
            a[k] += v
        log(f"  {curve}: {json.dumps(rep)}")
    a["bound_ms"], a["bound_by"] = bound_ms(a["bytes"], a["ops"])
    log(f"  jac_add (G1 + G2 at (C, 1), the combine's shape, device time): "
        f"{a['ms']:.5f} ms, {a['plain']:.2f} ms plain, bound "
        f"{a['bound_ms']:.7f} ms ({a['bound_by']}), "
        f"{a['bound_ms'] / a['ms']:.2%} of it")
    return a


def _jac_form_checks(torch, pool, digits, curve, check, forms, rep) -> None:
    """The Jacobian MSM's three forms against their plain versions on the
    card at the path's shapes, on the 2^16 MSM's own sorted digits: the
    scan steps of the first window chunk at offsets 1, 128 and its last
    (the lanes the kernel must write start as zeros; the plain version row
    by row), that chunk's bucket reduction, and Horner over the 32 window
    totals. Each timed beside its bound: the offset-1 step by CUDA events,
    the reduction and Horner by device time, with the chain's dependent
    Fq products (JAC_ADD_STAGES an add, JAC_DBL_STAGES a doubling). Adds
    each form's numbers into forms[name]."""
    import numpy as np

    from zelana_tpu_torch.ops import curve_kernels as CK
    from zelana_tpu_torch.ops import curve_ops as CO
    from zelana_tpu_torch.ops import msm as JM

    dev, C = pool.device, CK.rows(curve)
    order = np.argsort(digits.astype(np.uint8), axis=1, kind="stable")
    cw = JM._window_chunk(digits.shape[1])
    pos, ends, steps = JM.scan_plan(digits[:cw])
    src = JM._k_gather_points(pool, torch.from_numpy(order[:cw]).to(dev),
                              curve)
    dst = torch.empty_like(src)
    pos_d = torch.from_numpy(pos).to(dev)
    f = forms["jac_scan"]
    for k in range(steps):
        off = 1 << k
        if off in (1, 128, 1 << (steps - 1)):
            got = torch.where((pos_d < off // 2)[None], src,
                              torch.zeros_like(src))
            CO.jac_scan_step(src, got, pos_d, off, curve)
            t0 = time.time()
            for r in range(cw):
                f["err"] = max(f["err"], check(
                    f"jac_scan {curve} offset {off} row {r}",
                    got[:, r:r + 1], CO.jac_scan_step_plain(
                        src[:, r:r + 1], pos_d[r:r + 1], off, curve)))
            torch.cuda.synchronize()
            plain = 1e3 * (time.time() - t0)
            ms = cuda_ms(torch, lambda: CO.jac_scan_step(
                src, got, pos_d, off, curve), 5)
            adds = int((pos >= off).sum())
            copies = int(((pos >= off // 2) & (pos < off)).sum())
            work = (4 * (C * (3 * adds + 2 * copies) + pos.size),
                    adds * JAC_ADD_OPS[curve])
            b = bound_ms(*work)
            rep[f"jac_scan_offset_{off}"] = {
                "ms": ms, "plain_ms": plain, "bound_ms": b[0],
                "bound_by": b[1], "adds": adds, "lanes": pos.size}
            if off == 1:
                for key, v in zip(("ms", "plain", "bytes", "ops"),
                                  (ms, plain) + work):
                    f[key] += v
            del got
        CO.jac_scan_step(src, dst, pos_d, off, curve)
        src, dst = dst, src
    del dst
    # the chunk's bucket reduction
    f = forms["jac_reduce"]
    ends_d = torch.from_numpy(ends).to(dev)
    out = torch.empty((C, cw), dtype=torch.int32, device=dev)
    CO.jac_bucket_reduce(src, ends_d, out, curve)
    t0 = time.time()
    f["err"] = max(f["err"], check(
        f"jac_reduce {curve} {cw} windows", out,
        CO.jac_bucket_reduce_plain(src, ends_d, curve)))
    plain = 1e3 * (time.time() - t0)
    ms = device_ms(torch, lambda: CO.jac_bucket_reduce(src, ends_d, out,
                                                       curve), 5, 1)
    work = (4 * C * (int((ends >= 0).sum()) + cw) + ends.nbytes,
            _reduce_adds(ends) * JAC_ADD_OPS[curve])
    chain = JM.N_BUCKETS * JAC_ADD_STAGES
    rep["jac_reduce_chunk"] = {"device_ms": ms, "plain_ms": plain,
                               "bound_ms": bound_ms(*work)[0],
                               "dependent_products": chain,
                               "ms_per_dependent_product": ms / chain}
    for key, v in zip(("ms", "plain", "bytes", "ops", "chain"),
                      (ms, plain) + work + (chain,)):
        f[key] += v
    del src, out
    # Horner over the MSM's 32 window totals
    f = forms["jac_horner"]
    totals = JM._window_totals(pool, digits, curve)
    got = CO.jac_horner(totals, curve)
    t0 = time.time()
    f["err"] = max(f["err"], check(f"jac_horner {curve} 32 windows", got,
                                   CO.jac_horner_plain(totals, curve)))
    plain = 1e3 * (time.time() - t0)
    ms = device_ms(torch, lambda: CO.jac_horner(totals, curve), 5, 1)
    w = totals.shape[1] - 1
    work = (4 * C * (w + 2), w * (CO.WINDOW_BITS * JAC_DBL_OPS[curve]
                                  + JAC_ADD_OPS[curve]))
    chain = w * (CO.WINDOW_BITS * JAC_DBL_STAGES + JAC_ADD_STAGES)
    rep["jac_horner"] = {"device_ms": ms, "plain_ms": plain,
                         "bound_ms": bound_ms(*work)[0],
                         "dependent_products": chain,
                         "ms_per_dependent_product": ms / chain}
    for key, v in zip(("ms", "plain", "bytes", "ops", "chain"),
                      (ms, plain) + work + (chain,)):
        f[key] += v
    log(f"  {curve} forms at the path's shapes: "
        f"{json.dumps({k: v for k, v in rep.items() if 'jac_' in k})}")


def _edge_msms(torch, dev) -> None:
    """tests/test_msm.py:100-131's inputs on the card: a zero scalar, an
    identity point and P + (-P) (G1, 24 points), four G2 points; both MSMs
    against the host MSM."""
    import random

    from zelana_tpu_torch.curves import g1 as G1, g2 as G2
    from zelana_tpu_torch.fields.bn254 import R as FR
    from zelana_tpu_torch.ops import msm as JM
    from zelana_tpu_torch.ops import msm_fast as MF

    rng = random.Random(99)
    g = G1.generator()
    pts = [G1.mul(g, rng.randrange(1, FR)) for _ in range(24)]
    sc = [rng.randrange(FR) for _ in range(24)]
    sc[3] = 0
    pts[5] = None
    pts[10] = G1.neg(pts[9])
    sc[10] = sc[9]
    pts2 = [G2.mul(G2.generator(), rng.randrange(1, 10**5))
            for _ in range(4)]
    sc2 = [rng.randrange(FR) for _ in range(4)]
    for G, P, S, fns in ((G1, pts, sc, (MF.msm_g1, JM.msm_g1)),
                         (G2, pts2, sc2, (MF.msm_g2, JM.msm_g2))):
        want = G.msm([p for p in P if p is not None],
                     [s for p, s in zip(P, S) if p is not None])
        for fn in fns:
            if fn(P, S, device=dev) != want:
                raise AssertionError(f"{fn.__module__}.{fn.__name__} differs "
                                     f"from the host MSM on the edge inputs")
    log("  edge inputs (zero scalar, identity point, P + (-P); four G2 "
        "points): tape and Jacobian MSMs equal the host MSMs")


def phase_engines(torch, dev, report):
    """The tape MSM (msm_fast, the step kernel's mixed and general adds) and
    the Jacobian windowed MSM (msm: jac_scan, jac_reduce, jac_horner) at
    CHUNK_N = 2^16 points, G1 and G2, on tiled_msm's pools: both equal to
    the closed form and to msm_scan; the step launches split mixed /
    general equal to the tape's step counts; the Jacobian MSM's launches
    (its scan steps from its run positions, a reduction a window chunk,
    one Horner, no batch add); each MSM under the profiler with only its
    own kernels and the listed torch copies and gathers on the device;
    the Jacobian forms against their plain versions at the path's shapes
    (_jac_form_checks). Returns (kernel entries, launches of the MSM runs,
    the tape's launches, its step times, the batch add's numbers)."""
    import numpy as np

    from zelana_tpu_torch.ops import cuda
    from zelana_tpu_torch.ops import curve_kernels as CK
    from zelana_tpu_torch.ops import msm as JM
    from zelana_tpu_torch.ops import msm_fast as MF
    from zelana_tpu_torch.ops import msm_scan as MSM

    rng = np.random.default_rng(33)
    rep = report.setdefault("engines", {})
    mismatches = {}

    def check(name, got, want):
        mism, err = compare(torch, got, want)
        if mism:
            log(f"  {name}: mismatches {mism}, max |diff| {err}")
        mismatches[name.split()[0]] = mismatches.get(name.split()[0],
                                                     0) + mism
        return err

    jac_add = _jac_add_checks(torch, dev, rng, check,
                              rep.setdefault("point_kernels", {}))
    if any(mismatches.values()):
        raise AssertionError(f"jac_add differs from its plain version: "
                             f"{mismatches}")
    _edge_msms(torch, dev)

    n = MSM.CHUNK_N
    launches = dict.fromkeys(JAC_FORMS, 0)
    forms = {k: {"err": 0, "ms": 0.0, "plain": 0.0, "bytes": 0.0, "ops": 0.0,
                 "chain": 0} for k in JAC_FORMS}
    tape_runs = {"mixed": 0, "general": 0}
    step_times = {}
    step = CK.step
    for curve in ("g1", "g2"):
        pool, limbs, want = tiled_msm(torch, curve, n, rng, dev)
        digits = MSM.scalar_digits(limbs)
        prepared = (pool, np.zeros(n, bool), curve)
        got_scan = MSM.msm_end(MSM.msm_begin_scheds(
            prepared, MSM.build_segment_schedules(digits)))

        # the tape MSM, its step launches split by kind
        tape = MF.build_tape(digits)
        kinds = []

        def counting_step(*args, **kw):
            kinds.append(kw["mixed"])
            return step(*args, **kw)

        CK.step = counting_step
        try:
            cuda.reset_launches()
            torch.cuda.synchronize()
            t0 = time.time()
            got_tape = MF.msm_end(MF.msm_begin(prepared, None, curve,
                                               digits=digits))
            t_tape = 1e3 * (time.time() - t0)
            step_launches = cuda.LAUNCHES["step"]
        finally:
            CK.step = step
        steps = tape.idx.shape[0]
        mixed = sum(kinds)
        if (step_launches, mixed, len(kinds) - mixed) != (
                steps, tape.mixed_steps, steps - tape.mixed_steps):
            raise AssertionError(
                f"tape {curve}: {step_launches} step launches ({mixed} mixed)"
                f", the tape has {steps} steps ({tape.mixed_steps} mixed)")
        tape_runs["mixed"] += mixed
        tape_runs["general"] += steps - mixed

        # the Jacobian MSM and its point kernels' launches: a scan step for
        # each bit of a chunk's longest run position
        cuda.reset_launches()
        torch.cuda.synchronize()
        t0 = time.time()
        got_jac = JM._jac_to_affine_host(JM._msm(pool, digits, curve), curve)
        t_jac = 1e3 * (time.time() - t0)
        cw = JM._window_chunk(n)
        per = {"jac_scan": sum(JM.scan_plan(digits[w0:w0 + cw])[2]
                               for w0 in range(0, JM.N_WINDOWS, cw)),
               "jac_reduce": -(-JM.N_WINDOWS // cw), "jac_horner": 1,
               "jac_add": 0}
        for k, v in per.items():
            if cuda.LAUNCHES[k] != v:
                raise AssertionError(f"Jacobian MSM {curve}: {k} launched "
                                     f"{cuda.LAUNCHES[k]} times, expected "
                                     f"{v}")
            if k in launches:
                launches[k] += v
        if not got_tape == got_jac == got_scan == want:
            raise AssertionError(f"{curve} at 2^16: tape, Jacobian and "
                                 f"run-scan MSMs and the closed form differ")

        # times: the device part by CUDA events and by device time, beside
        # its bound; the tape's steps one by one at S
        tape_ms = cuda_ms(torch, lambda: MF.run_tape(pool, tape, curve), 3)
        tape_dev, _, events = device_profile(torch, lambda: MF.run_tape(
            pool, tape, curve), 2, steps)
        _only_kernels(events, TAPE_KERNELS, f"tape MSM {curve}")
        tb, tops, real_m, real_g = _tape_work(tape, curve)
        tape_bound = bound_ms(tb, tops)
        walls = []
        for _ in range(3):  # warm: the first call above loaded the kernels
            torch.cuda.synchronize()
            t0 = time.time()
            JM._msm(pool, digits, curve)
            torch.cuda.synchronize()
            walls.append(1e3 * (time.time() - t0))
        jac_ms = cuda_ms(torch, lambda: JM._msm(pool, digits, curve), 2)
        jac_dev, _, events = device_profile(torch, lambda: JM._msm(
            pool, digits, curve), 2, sum(per.values()))
        _only_kernels(events, JAC_KERNELS, f"Jacobian MSM {curve}")
        jac_bound = bound_ms(*_jac_msm_work(digits, curve))
        _jac_form_checks(torch, pool, digits, curve, check, forms,
                         rep.setdefault(f"{curve}_forms", {}))
        if any(mismatches.values()):
            raise AssertionError(f"Jacobian forms differ from their plain "
                                 f"versions: {mismatches}")
        tp = MF._pool(pool, tape, curve)
        idx, _finals = MF._upload_tape(tape, dev)
        S, a0 = tape.S, tape.a0
        for t in range(steps):
            step(tp, a0 + t * S, S, curve, idx[t, 0], idx[t, 1],
                 read_hi=a0 + t * S, mixed=t < tape.mixed_steps)
        for kind, t in (("mixed", 0), ("general", tape.mixed_steps)):
            is_mixed = kind == "mixed"
            ms = device_ms(torch, lambda: step(
                tp, a0 + t * S, S, curve, idx[t, 0], idx[t, 1],
                read_hi=a0 + t * S, mixed=is_mixed), 20, 1)
            rows = CK.rows(curve) * (2 if is_mixed else 3) // 3
            real = int((tape.idx[t, 0] != 0).sum())
            sb = bound_ms(4 * (2 * S * rows + S * CK.rows(curve) + 2 * S),
                          real * STEP_FQ[(curve, is_mixed)] * MUL_OPS)
            step_times[f"{curve} {kind}"] = {"device_ms": ms,
                                             "bound_ms": sb[0],
                                             "bound_by": sb[1],
                                             "pairs": real, "S": S}
        del tp, idx
        rep[curve] = {
            "tape": {"steps": steps, "mixed_steps": tape.mixed_steps,
                     "real_pairs": [real_m, real_g], "S": S,
                     "msm_wall_ms": t_tape, "device_events_ms": tape_ms,
                     "device_ms": tape_dev, "bound_ms": tape_bound[0],
                     "bound_by": tape_bound[1]},
            "jacobian": {"launches": per, "msm_wall_ms": t_jac,
                         "msm_warm_wall_ms": walls,
                         "device_events_ms": jac_ms, "device_ms": jac_dev,
                         "bound_ms": jac_bound[0],
                         "bound_by": jac_bound[1],
                         "bound_share": jac_bound[0] / jac_dev},
            "steps": {k: v for k, v in step_times.items()
                      if k.startswith(curve)}}
        log(f"engines {curve} {n} points: closed form = run-scan = tape = "
            f"Jacobian; {json.dumps(rep[curve])}")
        del pool, prepared
    entries = []
    # no Pallas kernel stands behind them: "replaces" names the JAX
    # package's XLA function (ops/msm.py's steps over curve_ops.point_add)
    for name, line in (("jac_scan", 110), ("jac_reduce", 163),
                       ("jac_horner", 154)):
        e = forms[name]
        e["bound_ms"], e["bound_by"] = bound_ms(e["bytes"], e["ops"])
        entries.append(_entry(name, "zelana_tpu_torch/csrc/jac_kernels.cu",
                              f"zelana_tpu/ops/msm.py:{line}", e["err"],
                              e["ms"], e["plain"], e["bound_ms"],
                              e["bound_by"]))
        entries[-1]["mismatches"] = mismatches[name]
        if e["chain"]:
            entries[-1]["dependent_products"] = e["chain"]
        log(f"  {name} (G1 + G2; the scan step at offset 1 by events, the "
            f"chains by device time): {e['ms']:.4f} ms, {e['plain']:.1f} ms "
            f"plain, bound {e['bound_ms']:.5f} ms ({e['bound_by']}), "
            f"{e['bound_ms'] / e['ms']:.1%} of it"
            + (f"; {e['chain']} dependent Fq products, "
               f"{1e3 * e['ms'] / e['chain']:.3f} us each" if e["chain"]
               else ""))
    entries.append(_entry("jac_add", "zelana_tpu_torch/csrc/jac_kernels.cu",
                          "zelana_tpu/ops/curve_ops.py:168", jac_add["err"],
                          jac_add["ms"], jac_add["plain"],
                          jac_add["bound_ms"], jac_add["bound_by"]))
    entries[-1]["mismatches"] = mismatches["jac_add"]
    rep["tape_launches"] = tape_runs
    rep["step_times"] = step_times
    log(f"engines: point kernel launches {launches}, step launches of the "
        f"tape MSMs {tape_runs}")
    return entries, launches, tape_runs, step_times


def phase_services(torch, dev, report) -> dict:
    """The prover's service entry points on the card: Groth16Prover.prove
    of the L2 dummy batch (batch 1, artifacts/l2_dummy_pk.npz) byte-equal
    to zelana_tpu_torch/testdata/l2_batch_proof.json and verified;
    OwnershipProver's seed-0 keygen and proof of the recorded witness
    equal to testdata/ownership_proof.json and verified. Returns the
    prover kernels' launches of the two proofs."""
    from zelana_tpu_torch.groth16.keys import ProvingKey
    from zelana_tpu_torch.ops import cuda
    from zelana_tpu_torch.runtime.ownership_api import OwnershipProver
    from zelana_tpu_torch.sequencer import prover_service as SP
    from zelana_tpu_torch.sequencer import transactions as TX

    rep = report.setdefault("services", {})
    with open("zelana_tpu_torch/testdata/l2_batch_proof.json") as f:
        vec = json.load(f)
    with open("zelana_tpu_torch/testdata/ownership_proof.json") as f:
        own_vec = json.load(f)
    cuda.reset_launches()
    prover = SP.Groth16Prover(ProvingKey.load_npz(vec["key"]))
    inputs = SP.BatchPublicInputs(**{
        k: bytes.fromhex(v) if isinstance(v, str) else v
        for k, v in vec["inputs"].items()})
    witness = SP.BatchWitness(
        transactions=[TX.Transfer(bytes.fromhex(a), bytes.fromhex(b), amount,
                                  nonce)
                      for a, b, amount, nonce in vec["transfers"]],
        initial_accounts={bytes.fromhex(pk): balance
                          for pk, balance in vec["initial_accounts"]})
    torch.cuda.synchronize()
    t0 = time.time()
    proof = prover.prove(inputs, witness)
    t1 = time.time()
    if proof.proof_bytes.hex() != vec["proof_bytes"]:
        raise AssertionError("Groth16Prover: the batch 1 proof differs from "
                             "the recorded JAX vector")
    if not prover.verify(proof):
        raise AssertionError("Groth16Prover: the proof does not verify")
    own = OwnershipProver()
    t2 = time.time()
    res = own.prove(*own_vec["witness"])
    t3 = time.time()
    for key in ("proof", "public_inputs", "public_witness"):
        if res[key] != own_vec[key]:
            raise AssertionError(f"OwnershipProver: {key} differs from the "
                                 f"recorded JAX vector")
    if not own.verify(bytes.fromhex(res["proof"]),
                      [int(v) for v in res["public_inputs"]]):
        raise AssertionError("OwnershipProver: the proof does not verify")
    launches = {k: cuda.LAUNCHES[k] for k in ("ntt_pass", "runscan",
                                              "bucket_tail", "step")}
    if not all(launches.values()):
        raise AssertionError(f"services: a prover kernel was not launched: "
                             f"{launches}")
    rep.update(groth16_prove_ms=1e3 * (t1 - t0),
               ownership_keygen_and_prove_ms=1e3 * (t3 - t2),
               ownership_prove_ms=res["proving_time_ms"], launches=launches)
    log(f"services: Groth16Prover batch 1 {rep['groth16_prove_ms']:.1f} ms "
        f"(first prove: key upload and NTT plan included), byte-equal and "
        f"verified; OwnershipProver keygen + prove "
        f"{rep['ownership_keygen_and_prove_ms']:.1f} ms (prove "
        f"{res['proving_time_ms']} ms), equal and verified; launches "
        f"{launches}")
    return launches


# ---------------------------------------------------------------------------
# the shielded transfer circuit: keygen and prove at a 2^15 domain
# ---------------------------------------------------------------------------

# the prover kernels' launch counters and their device kernels' names
SHIELDED_DEVICE = {"ntt_pass": ("ntt_pass_kernel",),
                   "runscan": ("runscan_kernel",),
                   "bucket_tail": ("bucket_merge_kernel",
                                   "bucket_tree_kernel")}


def phase_shielded(torch, dev, report) -> dict:
    """The shielded transfer (circuits/shielded.py, 2 inputs, 2 outputs,
    depth 32, a 2^15 domain) keygen'd and proved on the card through the
    generic keygen / prove / verify, held to
    zelana_tpu_torch/testdata/shielded_proof.json (the JAX package's seed-0
    key and batch-1 proof of the same instance): the key's SHA-256, the
    proof's bytes, verify; the launches of keygen and of each proof against
    what the NTT plan, the fixed-base chunks and the MSM segments say; the
    path's kernels against their plain versions on the card at the path's
    shapes (the 2^15 witness map, the a query's run-scans and bucket tail
    on the schedule the prove built, the keygen's step rounds on its own
    chunks); a warm proof under torch.profiler; a tampered instance
    refused on the host with no launch. Returns the launches: the kernels
    of one proof, and step of the keygen."""
    import hashlib

    from zelana_tpu_torch.circuits import shielded as S
    from zelana_tpu_torch.groth16 import prove as GP
    from zelana_tpu_torch.groth16.keys import prepare_queries
    from zelana_tpu_torch.groth16.qap import matrix_vector_evals
    from zelana_tpu_torch.groth16.setup import keygen
    from zelana_tpu_torch.groth16.verify import verify
    from zelana_tpu_torch.ops import cuda
    from zelana_tpu_torch.ops import curve_kernels as CK
    from zelana_tpu_torch.ops import fixed_base as FB
    from zelana_tpu_torch.ops import limbs as L
    from zelana_tpu_torch.ops import msm_scan as MSM
    from zelana_tpu_torch.ops import ntt as NTT
    from zelana_tpu_torch.poly.domain import Domain
    from zelana_tpu_torch.r1cs.system import ConstraintSystem
    from zelana_tpu_torch.sequencer.prover_service import \
        proof_to_solana_bytes

    sys.path.insert(0, os.path.abspath("tools"))
    from record_service_vectors import shielded_instance

    rep = report.setdefault("shielded", {})
    with open("zelana_tpu_torch/testdata/shielded_proof.json") as f:
        vec = json.load(f)
    const, batch_id = vec["instance"], vec["instance"]["batch_id"]
    t0 = time.time()
    circuit = shielded_instance(S, const)
    cs = ConstraintSystem()
    circuit.generate_constraints(cs)
    A, B, C = cs.matrices()
    z, ni = cs.full_assignment(), cs.num_instance
    pub = cs.instance_values[1:]
    if [str(v) for v in pub] != vec["public_inputs"]:
        raise AssertionError("shielded: public inputs differ from the vector")
    domain = Domain.new(len(A) + ni)
    log_n = domain.size.bit_length() - 1
    rep.update(num_vars=len(z), num_constraints=len(A), domain=domain.size,
               instance_ms=(time.time() - t0) * 1e3)
    log(f"shielded instance (NoteTree, synthesis): "
        f"{rep['instance_ms']:.1f} ms; {len(z)} variables, {len(A)} "
        f"constraints, domain 2^{log_n}")

    # keygen: the step launches, one a fixed-base chunk of each query
    chunks, run_fb = [], FB._run_fb

    def keep(head, words, curve):
        chunks.append((head, words, curve))
        return run_fb(head, words, curve)

    FB._run_fb = keep
    torch.cuda.synchronize()
    cuda.reset_launches()
    t0 = time.time()
    try:
        pk = keygen(circuit, seed=0)
    finally:
        FB._run_fb = run_fb
    torch.cuda.synchronize()
    rep["keygen_ms"] = (time.time() - t0) * 1e3
    kg = {k: v for k, v in cuda.LAUNCHES.items() if v}
    want_step = sum(-(-n // FB.FB_CHUNK)
                    for n in (len(z), len(z), len(z), domain.size - 1,
                              len(z) - ni))
    if kg != {"step": want_step} or len(chunks) != want_step:
        raise AssertionError(f"shielded keygen launched {kg}, not "
                             f"{want_step} step (a chunk of each query)")
    digest = hashlib.sha256(pk.serialize_compressed()).hexdigest()
    if digest != vec["key_sha256"] or \
            pk.vk.serialize_compressed().hex() != vec["vk"]:
        raise AssertionError("shielded keygen: the seed-0 key differs from "
                             "the JAX vector")
    rep["keygen_launches"] = kg
    log(f"shielded keygen (seed 0): {rep['keygen_ms']:.1f} ms wall, "
        f"launches {kg}; key SHA-256 equal to the JAX vector")

    # proofs: the first (key upload and NTT plan included), two warm
    segs, build = [], MSM.build_segment_schedules

    def keep_segs(digits, *a, **k):
        out = build(digits, *a, **k)
        segs.append((digits.shape[1], out))
        return out

    MSM.build_segment_schedules = keep_segs
    torch.cuda.synchronize()
    cuda.reset_launches()
    times = []
    try:
        for _ in range(3):
            t0 = time.time()
            proof = GP.prove(pk, circuit, batch_id=batch_id)
            times.append((time.time() - t0) * 1e3)
            if proof.serialize_compressed().hex() != vec["proof"] or \
                    proof_to_solana_bytes(proof).hex() != vec["proof_bytes"]:
                raise AssertionError("shielded proof differs from the JAX "
                                     "vector")
    finally:
        MSM.build_segment_schedules = build
    torch.cuda.synchronize()
    launches = {k: v // 3 for k, v in cuda.LAUNCHES.items() if v}
    if not verify(pk.vk, proof, pub):
        raise AssertionError("shielded proof does not verify")
    # the first proof's two schedule sets, z's and h's (h on a worker)
    segs_z, = [ss for n, ss in segs[:2] if n == len(z)]
    segs_h, = [ss for n, ss in segs[:2] if n == domain.size - 1]
    msm_segs = 4 * len(segs_z) + len(segs_h)
    want = {"ntt_pass": 7 * len(NTT.default_split(log_n)),
            "runscan": 2 * msm_segs, "bucket_tail": 2 * msm_segs}
    if launches != want or any(v % 3 for v in cuda.LAUNCHES.values()):
        raise AssertionError(f"3 shielded proofs launched {cuda.LAUNCHES}, "
                             f"not {want} a proof (7 transforms x "
                             f"{NTT.default_split(log_n)}; two scans and a "
                             f"two-launch tail a segment)")
    for name, ss in (("z", segs_z), ("h", segs_h)):
        for s in ss:
            sc = s["sched"]
            K2 = sc.dense_idx.shape[0]
            log(f"  {name} segment [{s['lo']}, {s['hi']}): R "
                f"{sc.pid.shape[0] - 1} x {sc.pid.shape[1]} lanes, R2 "
                f"{sc.pos2.shape[0] - 1} x {sc.pos2.shape[1]} lanes, K2 {K2}")
            if K2 > MSM.K2_BOUND:
                raise AssertionError(f"{name} schedule: K2 {K2} above "
                                     f"{MSM.K2_BOUND}")
    rep.update(first_prove_ms=times[0], warm_prove_ms=times[1:],
               launches=launches)
    log(f"shielded prove batch {batch_id}: first {times[0]:.1f} ms, warm "
        f"{times[1]:.1f} / {times[2]:.1f} ms; byte-equal to the JAX vector "
        f"and verified; launches a proof {launches}, no mont_mul or "
        f"poseidon")

    # the path's kernels against their plain versions on the card
    err = 0

    def check(what, got, ref):
        mism, e = compare(torch, got, ref)
        log(f"  {what}: mismatches {mism}, max |diff| {e}")
        if mism:
            raise AssertionError(f"{what} differs from the plain version")
        return e

    t0 = time.time()
    plan = NTT.make_plan(domain.size)
    evals = [L.to_tensor(L.encode_mont(
        matrix_vector_evals(M, z, domain, M is A, ni), L.FR), dev)
        for M in (A, B, C)]
    err = max(err, check(
        f"witness map 2^{log_n} {NTT.default_split(log_n)}",
        GP.witness_map(evals, plan), GP.witness_map(evals, plan, plain=True)))
    q = prepare_queries(pk, dev)
    seg = segs_z[0]
    d, pool = seg["dev"], q["a"][0][:, seg["lo"]:seg["hi"]]
    emit = CK.runscan(pool, d["pid"], d["flag"], "g1")
    err = max(err, check(
        f"runscan g1 level 1, a query, {tuple(d['flag'].shape)}", emit,
        CK.runscan_plain(pool, d["pid"], d["flag"], "g1")))
    C1 = CK.rows("g1")
    pool2 = emit.view(C1, -1)
    emit2 = CK.runscan(pool2, d["pos2"], d["flag2"], "g1", True)
    err = max(err, check(
        f"runscan g1 level 2, a query, {tuple(d['flag2'].shape)}", emit2,
        CK.runscan_plain(pool2, d["pos2"], d["flag2"], "g1", True)))
    emit2 = emit2.view(C1, -1)
    K = d["dense"].numel() // CK.NB
    err = max(err, check(
        f"bucket_tail g1, a query (K {K})",
        CK.bucket_tail(emit2, d["dense"], K, "g1"),
        CK.bucket_tail_plain(emit2, d["dense"], K, "g1")))
    for curve in ("g1", "g2"):  # the h chunk (the longest), the b2 chunk
        head, words, _ = max((c for c in chunks if c[2] == curve),
                             key=lambda c: c[1].shape[1])
        n = words.shape[1]
        ia, ib = FB._slot_ids(words)
        head_n = FB.N_TABLE + 1
        p = torch.empty((head.shape[0], head_n + n), dtype=torch.int32,
                        device=dev)
        p[:, :head_n] = head
        S_ = n * FB.N_WINDOWS // 2

        def rounds(pool, plain=False):
            if plain:
                return CK.step_plain(pool, head_n, S_, curve, ia, ib,
                                     rounds=FB.ROUNDS)
            return CK.step(pool, head_n, S_, curve, ia, ib, read_hi=head_n,
                           rounds=FB.ROUNDS)

        err = max(err, check(
            f"step {curve}, keygen chunk of {n} scalars, {FB.ROUNDS} rounds",
            rounds(p.clone()), rounds(p.clone(), plain=True)))
        ms = cuda_ms(torch, lambda: rounds(p), 5)
        bms, by = bound_ms(*step_work(n, curve))
        rep[f"step_{curve}"] = {"scalars": n, "ms": ms, "bound_ms": bms,
                                "bound_by": by}
        log(f"  step {curve}, {n} scalars: {ms:.4f} ms by events, bound "
            f"{bms:.4f} ms ({by}), {bms / ms:.1%} of it")
    rep["plain_checks_s"] = time.time() - t0
    rep["max_abs_err"] = err
    log(f"shielded path kernels bit-equal to their plain versions "
        f"({rep['plain_checks_s']:.1f} s)")

    # a warm proof under the profiler: busy time, idle share, and each
    # kernel's device time beside its bound. A window can come back short
    # of its kernels (device_profile): up to three proofs are profiled, one
    # whose window holds every launch ends the search, the fullest counts
    def kept(events):
        return {k: sum(e.count for e in events
                       if any(nm in e.key for nm in names))
                for k, names in SHIELDED_DEVICE.items()}

    best = None
    for _ in range(3):
        with profiled(torch) as prof:
            t0 = time.time()
            GP.prove(pk, circuit, batch_id=batch_id)
            torch.cuda.synchronize()
            wall = (time.time() - t0) * 1e3
        seen = kept(device_events(prof))
        if best is None or sum(seen.values()) > sum(best[2].values()):
            best = (prof, wall, seen)
        if seen == launches:
            break
    prof, wall, seen = best
    busy = _device_busy_ms(prof, "shielded prove")
    events = device_events(prof)
    bounds = {"ntt_pass": [bound_ms(32 * domain.size * 4,
                                    witness_map_products(log_n) * MUL_OPS)]}
    for key, curve, ss in (("a", "g1", segs_z), ("b1", "g1", segs_z),
                           ("l", "g1", segs_z), ("b2", "g2", segs_z),
                           ("h", "g1", segs_h)):
        Cq = CK.rows(curve)
        for s in ss:
            d = s["dev"]
            pool = q[key][0][:, s["lo"]:s["hi"]]
            lvl2 = torch.empty((Cq, 0), dtype=torch.int32, device=dev)
            K = d["dense"].numel() // CK.NB
            bounds.setdefault("runscan", []).extend([
                bound_ms(*runscan_work(torch, pool, d["pid"], d["flag"],
                                       curve, False)),
                bound_ms(*runscan_work(torch, lvl2, d["pos2"], d["flag2"],
                                       curve, True))])
            bounds.setdefault("bucket_tail", []).append(
                bound_ms(*tail_work(torch, None, d["dense"], K, curve)))
    per = {}
    for k, names in SHIELDED_DEVICE.items():
        ms = sum(e.self_device_time_total for e in events
                 if any(nm in e.key for nm in names)) / 1e3
        bms = sum(b[0] for b in bounds[k])
        by = max(bounds[k])[1]
        per[k] = {"device_ms": ms, "kernels_kept": seen[k], "bound_ms": bms,
                  "bound_by": by}
        log(f"  {k}: {ms:.4f} ms of device time a proof ({seen[k]} of "
            f"{launches[k]} launches in the window), bound {bms:.4f} ms "
            f"({by}), {bms / ms:.1%} of it" if ms else
            f"  {k}: no device time in the window")
    rep.update(profiled_wall_ms=wall, device_busy_ms=busy,
               idle_share=1 - busy / wall, kernels=per)
    log(f"shielded prove under the profiler: {wall:.1f} ms wall, device busy "
        f"{busy:.2f} ms, idle share {1 - busy / wall:.4f}")

    # a tampered instance (fee + 1) is refused on the host, before a launch
    bad = shielded_instance(S, const, lambda c: setattr(c, "fee", c.fee + 1))
    torch.cuda.synchronize()
    cuda.reset_launches()
    try:
        GP.prove(pk, bad, batch_id=batch_id)
    except ValueError as e:
        if "unsatisfied" not in str(e):
            raise
    else:
        raise AssertionError("the tampered shielded instance was proved")
    if any(cuda.LAUNCHES.values()):
        raise AssertionError(f"the tampered instance launched "
                             f"{cuda.LAUNCHES}")
    log("tampered instance (fee + 1): refused on the host, no launch")
    return {**launches, **kg}


# ---------------------------------------------------------------------------
# the served front: sequencer pipeline, HTTP API, worker
# ---------------------------------------------------------------------------

SERVED_KERNELS = ("ntt_pass", "runscan", "bucket_tail")
SERVED_CHUNK_BATCH = 11


def http(port: int, method: str, path: str, body=None):
    """(status, JSON answer) of one request to a local server."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method=method)
    if data:
        req.add_header("Content-Type", "application/json")
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def served_chunk_batch():
    """The batch of the served chunk job: 15 funded accounts, 10
    transfers, 5 withdrawals and 5 shielded commitments (two production
    chunks)."""
    accounts = [(pk_i, 10_000) for pk_i in range(1, 16)]
    transfers = [(1 + (i % 8), 1 + ((i + 3) % 8), 10 + i) for i in range(10)]
    withdrawals = [(1 + i, 0xAA00 + i, 5 + i) for i in range(5)]
    shielded = [1000 + i for i in range(5)]
    return accounts, transfers, withdrawals, shielded


def served_chunks(depth: int, cap) -> list:
    """The served chunk job's chunks with their witnesses."""
    from zelana_tpu_torch.runtime.chunk_witness import ChunkWitnessBuilder
    from zelana_tpu_torch.runtime.coordinator import Dispatcher

    accounts, transfers, withdrawals, shielded = served_chunk_batch()
    builder = ChunkWitnessBuilder(depth)
    for a_i, bal in accounts:
        builder.fund(a_i, bal)
    return Dispatcher.build_chunks_with_witness(
        builder, transfers, withdrawals, shielded, capacity=cap,
        pre_shielded_root=0)


def served_launches(what: str) -> dict:
    """The served path's launches of the prover's kernels, each nonzero."""
    from zelana_tpu_torch.ops import cuda

    got = {k: cuda.LAUNCHES[k] for k in SERVED_KERNELS}
    if not all(got.values()):
        raise AssertionError(f"{what}: a prover kernel was not launched: "
                             f"{got}")
    return got


def phase_sequencer(torch, report, chunk_prover=None) -> dict:
    """The sequencer served on the card, through its HTTP API: the L2
    pipeline's batch proved and settled through the on-chain verifier gate
    (byte-equal to testdata/pipeline_l2_proof.json); the production chunk
    job through the worker (both chunks verified, chained and byte-equal to
    prove_chunks in-process); /v2/ownership/prove equal to
    testdata/ownership_proof.json. `chunk_prover`: the production phase's,
    else made here. Returns the prover kernels' launches on the served
    paths (the L2 batch and the chunk job)."""
    from zelana_tpu_torch.groth16.keys import ProvingKey
    from zelana_tpu_torch.ops import cuda
    from zelana_tpu_torch.runtime.chunk_prover import Groth16ChunkProver
    from zelana_tpu_torch.runtime.coordinator import ChunkProof, Dispatcher
    from zelana_tpu_torch.runtime.ownership_api import OwnershipProver
    from zelana_tpu_torch.runtime.worker import http_chunk_prover, start_worker
    from zelana_tpu_torch.sequencer.account_tree import AccountState
    from zelana_tpu_torch.sequencer.api import start_api
    from zelana_tpu_torch.sequencer.batch import BatchConfig
    from zelana_tpu_torch.sequencer.pipeline import (
        PipelineConfig, PipelineOrchestrator, PipelineService, ProverMode)
    from zelana_tpu_torch.sequencer.prover_service import Groth16Prover
    from zelana_tpu_torch.sequencer.settler import OnchainVerifyingSettler

    rep = report.setdefault("sequencer", {})
    with open("zelana_tpu_torch/testdata/pipeline_l2_proof.json") as f:
        vec = json.load(f)
    with open("zelana_tpu_torch/testdata/ownership_proof.json") as f:
        own_vec = json.load(f)

    # 1. the L2 pipeline over HTTP; its first CUDA work runs on the
    # pipeline's prove thread
    pk = ProvingKey.load_npz(vec["key"])
    settler = OnchainVerifyingSettler(pk.vk)
    orch = PipelineOrchestrator(
        config=PipelineConfig(batch=BatchConfig(max_age_secs=3600),
                              prover_mode=ProverMode.GROTH16),
        prover=Groth16Prover(pk, "cuda"), settler=settler, dev_mode=True)
    for account, balance in vec["initial_accounts"]:
        if balance:
            orch._persist_account(bytes.fromhex(account),
                                  AccountState(balance, 0))
            orch.tree.insert(bytes.fromhex(account), AccountState(balance, 0))
    service = PipelineService(orch).start()
    server, port = start_api(orch)
    try:
        code, res = http(port, "POST", "/transfer", vec["transfer"])
        if code != 200 or not res["accepted"]:
            raise AssertionError(f"sequencer: transfer refused: {res}")
        torch.cuda.synchronize()
        cuda.reset_launches()
        t0 = time.time()
        code, sealed = http(port, "POST", "/dev/seal", {})
        if sealed["sealed"] != vec["batch_id"]:
            raise AssertionError(f"sequencer: sealed {sealed}")
        batch = orch.batches.sealed[0]
        while http(port, "GET", "/status/stats")[1]["batches_settled"] < 1:
            if batch.error is not None:  # a failed prove or settlement
                raise AssertionError(f"sequencer: batch failed: "
                                     f"{batch.error}")
            if time.time() - t0 > 300:
                raise AssertionError("sequencer: the batch did not settle")
            time.sleep(0.005)
        rep["seal_to_settled_ms"] = 1e3 * (time.time() - t0)
        rep["l2_launches"] = served_launches("sequencer L2 batch")
        if batch.proof.proof_bytes.hex() != vec["proof_bytes"]:
            raise AssertionError("sequencer: the served proof differs from "
                                 "the recorded JAX vector")
        if settler.inner.submitted[0].hex() != vec["submit_batch"]:
            raise AssertionError("sequencer: the SubmitBatch instruction "
                                 "differs from the recorded JAX vector")
        got = {"roots": http(port, "GET", "/status/roots")[1],
               "accounts": {h: http(port, "GET", f"/account/{h}")[1]
                            for h in vec["accounts"]}}
        for key, value in got.items():
            if value != vec[key]:
                raise AssertionError(f"sequencer: {key} {value} differ from "
                                     f"the vector's {vec[key]}")
        rep["proving_time_ms"] = batch.proof.proving_time_ms
    finally:
        server.shutdown()
        server.server_close()
        service.stop()
    log(f"sequencer: the L2 batch {vec['batch_id']} settled "
        f"{rep['seal_to_settled_ms']:.1f} ms after "
        f"POST /dev/seal (proving_time_ms {rep['proving_time_ms']}: the "
        f"first prove, key upload and NTT plan included); proof and "
        f"SubmitBatch bytes equal to the JAX vector, roots and balances "
        f"equal; launches {rep['l2_launches']}")

    # 2. the production chunk job through the worker, and 3. ownership
    cap, depth = PRODUCTION
    if chunk_prover is None:
        t0 = time.time()
        chunk_prover = Groth16ChunkProver.setup(cap, depth, seed=0)
        torch.cuda.synchronize()
        log(f"sequencer: production key made in {time.time() - t0:.1f} s")
    worker, wport = start_worker(chunk_prover)
    api, port = start_api(
        orch, dispatcher=Dispatcher(http_chunk_prover(
            [f"http://127.0.0.1:{wport}"])),
        chunk_capacity=cap, chunk_depth=depth,
        ownership_prover=OwnershipProver())
    accounts, transfers, withdrawals, shielded = served_chunk_batch()
    try:
        health = http(wport, "GET", "/health")
        if health != (200, {"status": "ok", "capacity": list(cap),
                            "tree_depth": depth}):
            raise AssertionError(f"worker health: {health}")
        torch.cuda.synchronize()
        cuda.reset_launches()
        with most_at_once(chunk_prover, "prove_chunk") as proving:
            t0 = time.time()
            code, job = http(port, "POST", "/v2/batch/prove", {
                "batch_id": SERVED_CHUNK_BATCH,
                "accounts": [{"pk": a, "balance": b} for a, b in accounts],
                "transfers": transfers, "withdrawals": withdrawals,
                "shielded_commitments": shielded})
            if code != 200:
                raise AssertionError(f"/v2/batch/prove: {code} {job}")
            status = f"/v2/batch/{job['job_id']}/status"
            while (st := http(port, "GET", status)[1]["status"]) != "done":
                if st != "running" or time.time() - t0 > 600:
                    raise AssertionError(f"chunk job: {st}")
                time.sleep(0.01)
            rep["chunk_job_ms"] = 1e3 * (time.time() - t0)
        rep["chunks_at_once"] = proving[1]
        if proving[1] != 2:
            raise AssertionError(f"the worker proved {proving[1]} of the "
                                 f"job's two chunks at once, not 2")
        rep["chunk_launches"] = served_launches("sequencer chunk job")
        result = http(port, "GET", f"/v2/batch/{job['job_id']}/proof")[1]
        served = [ChunkProof(
            chunk_index=c["index"], proof_bytes=bytes.fromhex(c["proof"]),
            public_inputs=[int(v) for v in c["public_inputs"]],
            proving_time_ms=c["proving_time_ms"],
            public_witness=bytes.fromhex(c["public_witness"]))
            for c in result["chunks"]]
        rep["chunk_ms"] = [c.proving_time_ms for c in served]
        if len(served) != 2:
            raise AssertionError(f"the job made {len(served)} chunks, not 2")
        for cp in served:
            if not chunk_prover.verify_chunk(cp):
                raise AssertionError(f"served chunk {cp.chunk_index} does "
                                     f"not verify")
        check_chain(served, "the served chunk job")
        chunks = served_chunks(depth, cap)
        t1 = time.time()
        local = chunk_prover.prove_chunks(chunks, SERVED_CHUNK_BATCH)
        rep["in_process_ms"] = 1e3 * (time.time() - t1)
        for got, want in zip(served, local):
            if (got.proof_bytes, got.public_witness) != (
                    want.proof_bytes, want.public_witness):
                raise AssertionError(f"served chunk {got.chunk_index} "
                                     f"differs from prove_chunks")
        log(f"sequencer: chunk job of 2 production chunks through the "
            f"worker, proved at once, {rep['chunk_job_ms']:.1f} ms (POST to "
            f"done), proving_time_ms per chunk {rep['chunk_ms']}; both "
            f"verify, roots chain, byte-equal to prove_chunks in-process "
            f"({rep['in_process_ms']:.1f} ms); launches "
            f"{rep['chunk_launches']}")

        t0 = time.time()
        code, own = http(port, "POST", "/v2/ownership/prove", dict(zip(
            ("spending_key", "value", "blinding", "position"),
            own_vec["witness"])))
        rep["ownership_ms"] = 1e3 * (time.time() - t0)
        if code != 200:
            raise AssertionError(f"/v2/ownership/prove: {code} {own}")
        rep["ownership_proving_time_ms"] = own.pop("proving_time_ms")
        if own != {k: v for k, v in own_vec.items()
                   if k not in ("witness", "recorded_with")}:
            raise AssertionError("/v2/ownership/prove differs from the "
                                 "recorded JAX vector")
        log(f"sequencer: /v2/ownership/prove {rep['ownership_ms']:.1f} ms "
            f"(seed-0 keygen included; proving_time_ms "
            f"{rep['ownership_proving_time_ms']}), equal to the vector")
    finally:
        for s in (api, worker):
            s.shutdown()
            s.server_close()
    return {k: rep["l2_launches"][k] + rep["chunk_launches"][k]
            for k in SERVED_KERNELS}


# ---------------------------------------------------------------------------
# the command line: in-process commands, then the commands that serve
# ---------------------------------------------------------------------------

CLI_KERNELS = ("ntt_pass", "runscan", "bucket_tail", "step")
CLI_CHUNK_BATCH = 12


def run_cli(argv) -> tuple:
    """(return code, printed lines, seconds) of one in-process command of
    the port's CLI (zelana_tpu_torch.cli.main); its lines are logged."""
    import contextlib
    import io

    from zelana_tpu_torch import cli

    out = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    seconds = time.time() - t0
    lines = out.getvalue().splitlines()
    for line in lines:
        log(f"  | {line}")
    return rc, lines, seconds


def smi(query: str) -> list:
    """Lines of `nvidia-smi --query-<query> --format=csv,noheader,nounits`."""
    return subprocess.run(
        ["nvidia-smi", f"--query-{query}", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()


def phase_cli(torch, report, card: str, chunk_prover=None) -> dict:
    """The port's command line (python -m zelana_tpu_torch.cli). In
    process, through cli.main: `keygen --seed 0` (both files equal to the
    JAX command's digests), `prove --pk <that file> --batch-id 1` (the
    proof equal to testdata/l2_dummy_proof.json), `verify` of it (every
    check True), `test --zk` (every line PASS, its key, proof and
    SubmitBatch equal to testdata/cli_vectors.json), `deploy` (the JAX
    descriptor) and `genkey` (mode 0600, keys that derive). As processes:
    `worker` (8/4/4, depth 32) through SwarmController, proving the served
    chunk job sent through Dispatcher(http_chunk_prover), byte-equal to
    prove_chunks in-process (`chunk_prover`: the production phase's, else
    made here); three `node`s and a NodeNetworkCoordinator proof; `dev
    --ephemeral` over the keygen's key, an `airdrop`, SIGINT. Returns the
    prover kernels' launches of the in-process commands."""
    import base64
    import hashlib
    import shutil
    import tempfile

    from zelana_tpu_torch.groth16 import setup
    from zelana_tpu_torch.ops import cuda
    from zelana_tpu_torch.sdk.keypair import ZelanaKeypair
    from zelana_tpu_torch.sequencer import bridge_program as bp

    rep = report.setdefault("cli", {"card": card})
    secs = rep["seconds"] = {}
    with open("zelana_tpu_torch/testdata/cli_vectors.json") as f:
        vec = json.load(f)
    with open("zelana_tpu_torch/testdata/l2_dummy_proof.json") as f:
        l2 = json.load(f)
    work = tempfile.mkdtemp(prefix="zelana_cli_")

    def path(name):
        return os.path.join(work, name)

    def sha(name):
        with open(path(name), "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()

    def command(name, argv) -> list:
        rc, lines, secs[name] = run_cli(argv)
        if rc not in (0, None):
            raise AssertionError(f"cli {name}: exit code {rc}")
        return lines

    try:
        torch.cuda.synchronize()
        cuda.reset_launches()
        lines = command("keygen", ["keygen", "--seed", "0",
                                   "--pk-out", path("proving.key"),
                                   "--vk-out", path("verifying.key")])
        want = vec["keygen"]
        if (sha("proving.key"), sha("verifying.key"), lines[-1]) != (
                want["pk_sha256"], want["vk_sha256"], want["vk_hash_line"]):
            raise AssertionError("cli keygen: the key files differ from the "
                                 "JAX command's")
        keygen_step = cuda.LAUNCHES["step"]

        lines = command("prove", ["prove", "--pk", path("proving.key"),
                                  "--batch-id", "1",
                                  "--out", path("l2_proof.json")])
        with open(path("l2_proof.json")) as f:
            proof = base64.b64decode(json.load(f)["proof"])
        if ", verified: True, -> " not in lines[-1] or (
                proof.hex() != l2["proof"]):
            raise AssertionError("cli prove: the proof differs from "
                                 "testdata/l2_dummy_proof.json")

        with open(path("verifying.key"), "rb") as f:
            vk_b64 = base64.b64encode(f.read()).decode()
        with open(path("vk.json"), "w") as f:
            json.dump({"verifying_key": vk_b64}, f)
        lines = command("verify", [
            "verify", "--proof", path("l2_proof.json"), "--vk",
            path("vk.json"), "--inputs", ",".join(l2["public_inputs"])])
        if len(lines) != 4 or not all(x.endswith(": True") for x in lines):
            raise AssertionError(f"cli verify: {lines}")

        seen = {"keys": [], "submits": []}
        keygen, process = setup.keygen, bp.BridgeSVM.process

        def keep_keygen(*a, **k):
            seen["keys"].append(keygen(*a, **k))
            return seen["keys"][-1]

        def keep_submit(self, ix):
            if ix.program_id == bp.BRIDGE_PROGRAM_ID and ix.data[:1] == b"\x03":
                seen["submits"].append(ix.data)
            return process(self, ix)

        setup.keygen, bp.BridgeSVM.process = keep_keygen, keep_submit
        try:
            lines = command("test_zk", ["test", "--zk"])
        finally:
            setup.keygen, bp.BridgeSVM.process = keygen, process
        want = vec["test_zk"]
        (zk_pk,), (submit,) = seen["keys"], seen["submits"]
        if lines[:-2] + lines[-1:] != want["lines"] or not lines[-2].startswith(
                "  [PASS] SubmitBatch Groth16 CPI verified ("):
            raise AssertionError(f"cli test --zk: {lines}")
        if (hashlib.sha256(zk_pk.serialize_compressed()).hexdigest(),
                submit.hex()) != (want["key_sha256"], want["submit_batch"]):
            raise AssertionError("cli test --zk: the key or the SubmitBatch "
                                 "differs from the JAX command's")

        lines = command("deploy", ["deploy", "--out",
                                   path("deployment.json")])
        with open(path("deployment.json")) as f:
            if f.read() != vec["deploy"]["descriptor"]:
                raise AssertionError("cli deploy: the descriptor differs "
                                     "from the JAX command's")
        command("genkey", ["genkey", path("id.json")])
        with open(path("id.json")) as f:
            doc = json.load(f)
        kp = ZelanaKeypair(bytes.fromhex(doc["signing_seed"]),
                           bytes.fromhex(doc["privacy_sk"]))
        if (oct(os.stat(path("id.json")).st_mode)[-3:] != "600"
                or (kp.pubkey.hex(), kp.privacy_pk.hex())
                != (doc["pubkey"], doc["privacy_pk"])):
            raise AssertionError("cli genkey: mode or keys wrong")
        torch.cuda.synchronize()
        launches = {k: cuda.LAUNCHES[k] for k in CLI_KERNELS}
        rep["cli_launches"] = launches
        if not all(launches.values()):
            raise AssertionError(f"cli: a kernel was not launched: "
                                 f"{launches}")
        log(f"{card}: cli in process: "
            + ", ".join(f"{k} {v:.2f} s" for k, v in secs.items())
            + f"; keygen and deploy equal to the JAX command's, the prove "
            f"and test --zk proofs equal to their vectors, verify True; "
            f"launches {launches} ({keygen_step} step in keygen)")

        _cli_worker(torch, rep, card, chunk_prover, work)
        _cli_nodes(rep, card, work)
        _cli_dev(rep, card, work, path("proving.key"))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return launches


def _cli_worker(torch, rep, card, chunk_prover, work) -> None:
    """`worker --capacity 8/4/4 --depth 32` as a process on the card: it
    keygens the seed-0 production key itself, then proves the served
    chunk job byte-equal to prove_chunks in-process. nvidia-smi lists its
    pid; where a container's pid namespace shows every process as another
    pid, it lists one more compute process while the worker runs than
    before and after, and the card's used memory rose while this process
    made no device work."""
    from zelana_tpu_torch.runtime.chunk_prover import Groth16ChunkProver
    from zelana_tpu_torch.runtime.control import SwarmController
    from zelana_tpu_torch.runtime.coordinator import Dispatcher
    from zelana_tpu_torch.runtime.worker import http_chunk_prover

    cap, depth = PRODUCTION
    ctl = SwarmController(log_dir=os.path.join(work, "swarm"),
                          device="cuda")
    try:
        pids0, mem0 = smi("compute-apps=pid"), int(smi("gpu=memory.used")[0])
        t0 = time.time()
        svc = ctl.start_worker("worker", "/".join(map(str, cap)), depth,
                               timeout=600)
        rep["worker_startup_s"] = time.time() - t0
        chunks = served_chunks(depth, cap)
        dispatcher = Dispatcher(http_chunk_prover([svc.url]))
        t0 = time.time()
        job = dispatcher.submit_job(chunks, CLI_CHUNK_BATCH)
        while (st := dispatcher.status(job)) != "done":
            if st not in ("queued", "running") or time.time() - t0 > 600:
                raise AssertionError(f"cli worker: the chunk job is {st}\n"
                                     + ctl.logs("worker"))
            time.sleep(0.01)
        rep["chunk_job_ms"] = 1e3 * (time.time() - t0)
        served = dispatcher.proofs(job)
        rep["chunk_proving_time_ms"] = [c.proving_time_ms for c in served]
        pids = smi("compute-apps=pid")
        mem1 = int(smi("gpu=memory.used")[0])
        pid = svc.process.pid
        log(ctl.logs("worker"))
        if chunk_prover is None:
            chunk_prover = Groth16ChunkProver.setup(cap, depth, seed=0)
        local = chunk_prover.prove_chunks(chunks, CLI_CHUNK_BATCH)
        if len(served) != len(local) or any(
                (a.proof_bytes, a.public_witness)
                != (b.proof_bytes, b.public_witness)
                for a, b in zip(served, local)):
            raise AssertionError("cli worker: a chunk differs from "
                                 "prove_chunks in-process")
    finally:
        ctl.stop()
    pids2, mem2 = smi("compute-apps=pid"), int(smi("gpu=memory.used")[0])
    rep["worker_memory_mib"] = [mem0, mem1, mem2]
    rep["compute_app_pids"] = [pids0, pids, pids2]
    if str(pid) in pids:
        rep["worker_on_card"] = f"nvidia-smi lists pid {pid}"
    elif (len(pids) == len(pids0) + 1 == len(pids2) + 1
          and mem1 - mem0 > 256):
        rep["worker_on_card"] = (
            f"nvidia-smi lists {len(pids)} compute processes while the "
            f"worker runs, {len(pids0)} before and after (pids {pids}: the "
            f"pid namespace maps pid {pid}), and {mem1 - mem0} MiB more "
            f"used memory")
    else:
        raise AssertionError(f"cli worker: pid {pid} not on the card "
                             f"(nvidia-smi pids {pids0} / {pids} / {pids2}, "
                             f"memory.used {mem0} / {mem1} / {mem2} MiB)")
    log(f"{card}: cli worker (8/4/4, depth 32) up in "
        f"{rep['worker_startup_s']:.1f} s (its keygen); chunk job of "
        f"{len(served)} chunks {rep['chunk_job_ms']:.1f} ms, proving_time_ms "
        f"{rep['chunk_proving_time_ms']}; byte-equal to prove_chunks "
        f"in-process; {rep['worker_on_card']}")


def _cli_nodes(rep, card, work) -> None:
    """Three `node` processes and a 3-of-3 Schnorr proof over them."""
    from zelana_tpu_torch.runtime.control import SwarmController
    from zelana_tpu_torch.runtime.prover_node import NodeNetworkCoordinator

    ctl = SwarmController(log_dir=os.path.join(work, "nodes"),
                          device="cuda")
    try:
        t0 = time.time()
        urls = [ctl.start_node(i + 1).url for i in range(3)]
        rep["nodes_startup_s"] = time.time() - t0
        t0 = time.time()
        message = b"zelana cli swarm"
        proof, pk = NodeNetworkCoordinator(urls).prove(2026 ** 7, message,
                                                       k=3)
        rep["node_proof_ms"] = 1e3 * (time.time() - t0)
        if not proof.verify(pk, message) or proof.verify(pk, message + b"!"):
            raise AssertionError("cli node: the swarm's proof does not "
                                 "verify")
    finally:
        ctl.stop()
    log(f"{card}: cli nodes: 3 up in {rep['nodes_startup_s']:.1f} s, a "
        f"3-of-3 Schnorr proof in {rep['node_proof_ms']:.1f} ms, verified")


def _cli_dev(rep, card, work, pk_path) -> None:
    """`dev --ephemeral` as a process with ZL_PROVER_MODE=groth16 over the
    keygen's key: it prints its Groth16Prover, takes an `airdrop`, and on
    SIGINT seals and exits 0; its shutdown batch must not end in a kernel
    fault."""
    import signal
    import threading

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, ZL_PROVER_MODE="groth16", ZL_MOCK_PROVER="0",
               ZL_PROVING_KEY=pk_path, PYTHONPATH=root, PYTHONUNBUFFERED="1")
    env.pop("ZL_CONFIG", None)
    t0 = time.time()
    proc = subprocess.Popen(
        [sys.executable, "-m", "zelana_tpu_torch.cli", "dev", "--ephemeral"],
        cwd=work, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, start_new_session=True,
        preexec_fn=lambda: signal.signal(signal.SIGINT, signal.SIG_DFL))
    lines = []
    reader = threading.Thread(target=lambda: lines.extend(proc.stdout),
                              daemon=True)
    reader.start()
    try:
        while not any("sequencer: http://" in x for x in lines):
            if proc.poll() is not None or time.time() - t0 > 300:
                raise AssertionError(f"cli dev did not come up: {lines}")
            time.sleep(0.05)
        rep["dev_startup_s"] = time.time() - t0
        if "prover: Groth16Prover (mode=groth16)\n" not in lines:
            raise AssertionError(f"cli dev: {lines}")
        url = [x for x in lines if "sequencer: http://" in x][0].rstrip(
            ).split(": ", 1)[1]
        rc, out, rep["airdrop_s"] = run_cli(
            ["airdrop", "5a" * 32, "--amount", "1234", "--url", url])
        if rc != 0:
            raise AssertionError("cli airdrop did not land within 10 s")
        t0 = time.time()
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=60)
        rep["dev_sigint_to_exit_s"] = time.time() - t0
        reader.join(timeout=5)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    text = "".join(lines)
    for line in lines:
        log(f"  dev | {line.rstrip()}")
    last = [x for x in lines if x.startswith("last batch ")]
    rep["dev_shutdown_batch"] = last[0].rstrip() if last else None
    if rc != 0 or rep["dev_sigint_to_exit_s"] > 25:
        raise AssertionError(f"cli dev: exit code {rc} "
                             f"{rep['dev_sigint_to_exit_s']:.1f} s after "
                             f"SIGINT")
    if "CUDA" in text or not last or "prove failed: constraint" not in (
            last[0]):
        raise AssertionError(f"cli dev: the shutdown batch: {last}")
    log(f"{card}: cli dev up in {rep['dev_startup_s']:.1f} s (torch import "
        f"and the key's host decoding), airdrop landed in "
        f"{rep['airdrop_s']:.2f} s, exit 0 {rep['dev_sigint_to_exit_s']:.1f} "
        f"s after SIGINT; shutdown batch: {rep['dev_shutdown_batch']}")


# ---------------------------------------------------------------------------
# phase 6: the production chunk, keygen and two pipelined proves
# ---------------------------------------------------------------------------


PRODUCTION_CHUNKS = 5  # BATCH_BENCH.json's batch: four full, one part
PRODUCTION_BATCH = 7
PRODUCTION_OCCUPANCY = [[8, 4, 4]] * 4 + [[4, 2, 2]]


def production_batch(builder, cap) -> list:
    """The five chunks of the production batch, the last half filled (36
    transfers, 18 withdrawals, 18 shielded slots, the first a
    full-verification spend), from 15 funded accounts."""
    from zelana_tpu_torch.runtime.coordinator import Dispatcher

    for pk_i in range(1, 16):
        builder.fund(pk_i, 10_000)
    note = builder.add_note(spending_key=777, value=50, blinding=42)
    nt, nw, ns = (c * (PRODUCTION_CHUNKS - 1) + c // 2 for c in cap)
    transfers = [(1 + (i % 8), 1 + ((i + 3) % 8), 10 + i) for i in range(nt)]
    withdrawals = [(1 + (i % 15), 0xAA00 + i, 5 + i) for i in range(nw)]
    shielded = [("full", note, 777, 0xFACE, 50, 4242)] + [
        1000 + i for i in range(ns - 1)]
    return Dispatcher.build_chunks_with_witness(
        builder, transfers, withdrawals, shielded, capacity=cap,
        pre_shielded_root=builder.shielded_root())


def occupancy(chunk) -> list:
    return [sum(1 for s in slots if s.is_valid) for slots in (
        chunk.transfers, chunk.withdrawals, chunk.shielded)]


def check_chain(cps, what: str) -> None:
    """Raise unless the state and shielded roots of consecutive chunk
    proofs chain."""
    for a, b in zip(cps, cps[1:]):
        x, y = a.public_inputs, b.public_inputs
        if x[1] != y[0] or x[3] != y[2]:
            raise AssertionError(f"{what}: the roots of chunks "
                                 f"{a.chunk_index} and {b.chunk_index} do "
                                 f"not chain")


@contextlib.contextmanager
def launches_per_prove():
    """The launches of each prove_synthesized call while the context is
    open, one dict of nonzero counts a call, in order (a chunk prove makes
    all its launches inside that call, on its calling thread: count serial
    proves only)."""
    from zelana_tpu_torch.groth16 import prove as P
    from zelana_tpu_torch.ops import cuda

    real, out = P.prove_synthesized, []

    def counted(*args, **kwargs):
        before = dict(cuda.LAUNCHES)
        proof = real(*args, **kwargs)
        out.append({k: v - before[k] for k, v in cuda.LAUNCHES.items()
                    if v != before[k]})
        return proof

    P.prove_synthesized = counted
    try:
        yield out
    finally:
        P.prove_synthesized = real


def phase_production(torch, report, mesh: bool = False) -> tuple:
    """Returns the kernel launches of the production keygen, the chunk
    prover and the serial batch ({"chunks", "proofs", "launches": a dict a
    chunk}). `mesh`: prove the first chunk again over a one-rank NCCL
    group."""
    from zelana_tpu_torch.groth16.keys import prepare_queries
    from zelana_tpu_torch.ops import cuda
    from zelana_tpu_torch.runtime.chunk_prover import Groth16ChunkProver
    from zelana_tpu_torch.runtime.chunk_witness import ChunkWitnessBuilder

    cap, depth = PRODUCTION
    rep = report["production"] = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda.reset_launches()
    # under the profiler: its device busy time splits keygen's wall time
    # into device work and the host around it
    with profiled(torch) as prof:
        since = time.perf_counter()
        t0 = time.time()
        prover = Groth16ChunkProver.setup(cap, depth, seed=0)
        torch.cuda.synchronize()
        rep["keygen_s"] = time.time() - t0
        launches = dict(cuda.LAUNCHES)
        rep["keygen_phases"] = _phases(since)
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

    # the batch of BATCH_BENCH.json: five chunks, the last half filled
    t0 = time.time()
    chunks = production_batch(ChunkWitnessBuilder(depth), cap)
    filled = [occupancy(c) for c in chunks]
    if filled != PRODUCTION_OCCUPANCY:
        raise AssertionError(f"the batch's chunks hold {filled} valid "
                             f"slots, not {PRODUCTION_OCCUPANCY}")
    log(f"batch witnesses (depth-32 SMT paths, {len(chunks)} chunks, "
        f"valid slots {filled}): {time.time() - t0:.2f} s")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    cuda.reset_launches()
    t0 = time.time()
    with launches_per_prove() as per_chunk:
        cps = prover.prove_chunks(chunks, batch_id=PRODUCTION_BATCH)
        torch.cuda.synchronize()
    rep["prove_chunks_s"] = time.time() - t0
    rep["prove_launches"] = dict(cuda.LAUNCHES)
    rep["chunk_launches"] = per_chunk
    rep["prove_peak_bytes"] = torch.cuda.max_memory_allocated()
    rep["prove_peak_over_key_bytes"] = rep["prove_peak_bytes"] - base
    rep["chunk_ms"] = [cp.proving_time_ms for cp in cps]
    log(f"prove_chunks, {len(cps)} chunks: {rep['prove_chunks_s']:.2f} s; "
        f"per chunk {rep['chunk_ms']} ms (first, then pipelined); launches "
        f"{rep['prove_launches']}; peak device memory "
        f"{rep['prove_peak_bytes'] / 2**30:.2f} GiB "
        f"({rep['prove_peak_over_key_bytes'] / 2**30:.2f} GiB over the "
        f"resident key)")
    for i, n in enumerate(per_chunk):
        log(f"  chunk {i}: launches {n}")
    if len(per_chunk) != len(cps) or sum(
            sum(n.values()) for n in per_chunk) != sum(
            rep["prove_launches"].values()):
        raise AssertionError("the chunks' launches do not add up to the "
                             "batch's")
    t0 = time.time()
    for cp in cps:
        if not prover.verify_chunk(cp):
            raise AssertionError(f"chunk {cp.chunk_index} does not verify")
    check_chain(cps, "prove_chunks")
    log(f"all {len(cps)} chunk proofs verify ({time.time() - t0:.2f} s), "
        f"roots chain")

    # one chunk prove under the profiler: device busy time against wall
    cuda.reset_launches()
    with profiled(torch) as prof:
        since = time.perf_counter()
        t0 = time.time()
        again = prover.prove_chunk(chunks[0], batch_id=PRODUCTION_BATCH)
        torch.cuda.synchronize()
        wall = (time.time() - t0) * 1e3
        phases = _phases(since)
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
    if mesh:
        _world1_nccl(torch, prover, chunks[0], cps[0], rep)
    return launches, prover, {"chunks": chunks, "proofs": cps,
                              "launches": per_chunk}


def _world1_nccl(torch, prover, chunk, want, rep) -> None:
    """The production chunk proved through prove_chunks over a one-rank
    NCCL group (a file store, in this process): an NCCL all_gather on the
    card, then the proof, byte-equal to the one-card proof `want`."""
    import tempfile

    import torch.distributed as dist

    from zelana_tpu_torch.groth16.keys import prepare_queries
    from zelana_tpu_torch.ops import cuda
    from zelana_tpu_torch.parallel import comm
    from zelana_tpu_torch.parallel import distributed as D
    from zelana_tpu_torch.runtime.chunk_prover import Groth16ChunkProver

    with tempfile.TemporaryDirectory() as tmp:
        mesh = D.init_file_store(os.path.join(tmp, "store"), 1, 0,
                                 backend="nccl", device="cuda")
        try:
            x = torch.arange(64, dtype=torch.int32, device=mesh.device)
            if mesh.backend != "nccl" or not torch.equal(
                    comm.all_gather_tiled(x, mesh), x):
                raise AssertionError(f"no NCCL all_gather on {mesh}")
            t0 = time.time()
            prepare_queries(prover.pk, mesh.device, mesh)
            torch.cuda.synchronize()
            pools_s = time.time() - t0
            meshed = Groth16ChunkProver(prover.pk, prover.capacity,
                                        prover.tree_depth,
                                        device=mesh.device, mesh=mesh)
            cuda.reset_launches()
            with recorded_merges() as merges:
                t0 = time.time()
                cp = meshed.prove_chunks([chunk], batch_id=7)[0]
                torch.cuda.synchronize()
                wall = time.time() - t0
            launches = {k: v for k, v in cuda.LAUNCHES.items() if v}
        finally:
            dist.destroy_process_group()
    if cp.proof_bytes != want.proof_bytes:
        raise AssertionError("the one-rank NCCL mesh proof differs from the "
                             "one-card proof")
    held = check_merges(torch, merges, (MSM_NB,), "one-rank NCCL chunk")
    rep["mesh_world1_nccl"] = {"pools_s": pools_s, "prove_s": wall,
                               "launches": launches, "merges_held": held}
    log(f"production chunk through a one-rank NCCL mesh: sharded pools "
        f"{pools_s:.2f} s, prove_chunks {wall:.2f} s, launches {launches}; "
        f"proof byte-equal to the one-card proof; merge_pairs equal to "
        f"bucket_merge_plain on its segment sums at {held}")


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


# ---------------------------------------------------------------------------
# `concurrent`: proves at once on one card against the serial proofs
# ---------------------------------------------------------------------------

CONCURRENT_PAIR = (1, 2)  # run (a): prove_chunk of these chunks at once
CONCURRENT_JOBS = ((0, 1), (2, 3))  # run (b): two jobs of these chunks
L2_BATCH = 1  # the batch of testdata/l2_dummy_proof.json


def at_once(fns, timeout: float = 900.0) -> list:
    """Run each of `fns` on its own thread, all released together; their
    results in order. An exception on any thread is raised here, and so is
    a thread still running after `timeout` seconds."""
    import concurrent.futures as cf
    import threading

    go = threading.Barrier(len(fns))

    def run(fn):
        go.wait()
        return fn()

    with cf.ThreadPoolExecutor(len(fns)) as ex:
        futures = [ex.submit(run, fn) for fn in fns]
        return [f.result(timeout=timeout) for f in futures]


@contextlib.contextmanager
def most_at_once(obj, name: str):
    """While open, obj's method `name` counts its calls that run at once;
    yields [running, most]."""
    import threading

    real, lock, count = getattr(obj, name), threading.Lock(), [0, 0]

    def counted(*args, **kwargs):
        with lock:
            count[0] += 1
            count[1] = max(count)
        try:
            return real(*args, **kwargs)
        finally:
            with lock:
                count[0] -= 1

    setattr(obj, name, counted)
    try:
        yield count
    finally:
        delattr(obj, name)


def launch_sum(counts) -> dict:
    out = {}
    for c in counts:
        for k, v in c.items():
            out[k] = out.get(k, 0) + v
    return out


def phase_concurrent(torch, report, prover, batch) -> None:
    """Proves at once on the card, each held to the serial proofs of the
    `production` phase (`batch`), any difference raising: (a) prove_chunk
    of chunks 1 and 2 on two threads; (b) two jobs, chunks [0, 1] and
    [2, 3], submitted at once to one Dispatcher(prover.prove_chunk), so
    that two prove_chunks run at once, their roots chained within each
    job; (c) an L2 prove of L2BlockCircuit.dummy() as batch 1 on a third
    thread while (b) runs, byte-equal to testdata/l2_dummy_proof.json.
    Each run's launches equal, kernel by kernel, the sum of the same
    proves' serial launches ((b) and (c) together: they overlap). Each
    run is also made in a row, on one thread, for its wall time and peak
    device memory beside the run's; (a) runs once more under the profiler
    for the device's busy time and idle share."""
    from zelana_tpu_torch.groth16.keys import ProvingKey
    from zelana_tpu_torch.groth16.prove import prove
    from zelana_tpu_torch.ops import cuda
    from zelana_tpu_torch.runtime.coordinator import Dispatcher

    rep = report["concurrent"] = {}
    chunks, want = batch["chunks"], batch["proofs"]

    def run(what, fns, expect, together: bool) -> list:
        """fns at once (together) or in a row; their results, after the
        launch check, with the wall time and peak memory in rep."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda.reset_launches()
        t0 = time.time()
        out = at_once(fns) if together else [fn() for fn in fns]
        torch.cuda.synchronize()
        wall = time.time() - t0
        got = {k: v for k, v in cuda.LAUNCHES.items() if v}
        if got != expect:
            raise AssertionError(f"{what}: launches {got}, the serial "
                                 f"proves' sum {expect}")
        rep[what] = {"wall_s": wall, "launches": got,
                     "peak_bytes": torch.cuda.max_memory_allocated()}
        return out

    def same(cps, idx, what: str) -> None:
        for cp, i in zip(cps, idx, strict=True):
            w = want[i]
            if (cp.chunk_index, cp.proof_bytes, cp.public_witness) != (
                    w.chunk_index, w.proof_bytes, w.public_witness):
                raise AssertionError(f"{what}: chunk {i} differs from "
                                     f"prove_chunks' proof")

    def logged(what: str, row: str, run_: str, extra: str = "") -> None:
        a, b = rep[run_], rep[row]
        log(f"concurrent {what}: {a['wall_s'] * 1e3:.1f} ms at once "
            f"against {b['wall_s'] * 1e3:.1f} ms in a row; peak device "
            f"memory {a['peak_bytes'] / 2**30:.2f} GiB "
            f"({b['peak_bytes'] / 2**30:.2f} in a row); launches "
            f"{a['launches']}, the serial sum{extra}")

    # (a) two chunk proves at once
    fns = [functools.partial(prover.prove_chunk, chunks[i], PRODUCTION_BATCH)
           for i in CONCURRENT_PAIR]
    expect = launch_sum(batch["launches"][i] for i in CONCURRENT_PAIR)
    same(run("a_in_a_row", fns, expect, False), CONCURRENT_PAIR,
         "prove_chunk in a row")
    same(run("a", fns, expect, True), CONCURRENT_PAIR, "(a)")
    logged("(a), prove_chunk of chunks 1 and 2 on two threads",
           "a_in_a_row", "a", "; both byte-equal to prove_chunks")
    with profiled(torch) as prof:
        same(run("a_profiled", fns, expect, True), CONCURRENT_PAIR,
             "(a) profiled")
    busy = _device_busy_ms(prof, "two chunk proves at once")
    wall = rep["a_profiled"]["wall_s"] * 1e3
    rep["a_profiled"].update(device_busy_ms=busy, idle_share=1 - busy / wall)
    log(f"concurrent (a) under the profiler: {wall:.1f} ms wall, device "
        f"busy {busy:.1f} ms, idle share {1 - busy / wall:.4f}; byte-equal")

    # (b) two jobs at once through one Dispatcher, (c) an L2 prove beside
    dispatcher = Dispatcher(prover.prove_chunk)
    if dispatcher.batch_prover is None:
        raise AssertionError("the Dispatcher did not wire prove_chunks")

    def job(idx) -> list:
        jid = dispatcher.submit_job([chunks[i] for i in idx],
                                    PRODUCTION_BATCH)
        deadline = time.time() + 600
        while (st := dispatcher.status(jid)) in ("queued", "running"):
            if time.time() > deadline:
                raise AssertionError(f"the job of chunks {idx} is {st}")
            time.sleep(0.01)
        if st != "done":
            raise AssertionError(f"the job of chunks {idx} is {st}: "
                                 f"{dispatcher.jobs[jid].error}")
        cps = dispatcher.proofs(jid)
        same(cps, idx, f"the job of chunks {idx}")
        check_chain(cps, f"the job of chunks {idx}")
        return cps

    with open("zelana_tpu_torch/testdata/l2_dummy_proof.json") as f:
        l2_want = json.load(f)["proof"]
    l2_pk = ProvingKey.load_npz("artifacts/l2_dummy_pk.npz")
    circuit = l2_circuit()

    def l2():
        proof = prove(l2_pk, circuit, batch_id=L2_BATCH)
        if proof.serialize_compressed().hex() != l2_want:
            raise AssertionError("the L2 proof differs from the recorded "
                                 "JAX vector")
        return proof

    cuda.reset_launches()
    l2()  # its pools on the card and its launches
    l2_launches = {k: v for k, v in cuda.LAUNCHES.items() if v}
    fns = [functools.partial(job, idx) for idx in CONCURRENT_JOBS] + [l2]
    expect = launch_sum([batch["launches"][i] for idx in CONCURRENT_JOBS
                         for i in idx] + [l2_launches])
    run("bc_in_a_row", fns, expect, False)
    run("bc", fns, expect, True)
    logged("(b) + (c), two jobs of two chunks through one Dispatcher and "
           "an L2 prove on a third thread", "bc_in_a_row", "bc",
           "; every chunk byte-equal to prove_chunks, the roots chained in "
           "each job, the L2 proof equal to the JAX vector")


# ---------------------------------------------------------------------------
# `mesh`: the multi-card path, four ranks on one card over gloo
# ---------------------------------------------------------------------------

MESH_WORLD = 4
MSM_NB = 8192  # the dense bucket array of the run-scan MSM (32 x 256)
MERGE_KEEP = 2  # merge_pairs calls recorded for each curve and width
MESH_SEED = 2026
MESH_NTT = 1 << 21  # one transform over the four ranks
MESH_MIMC = 1 << 20
MESH_SCAN = 1 << 16  # run-scan MSM points a rank, per curve
MESH_JAC = 1 << 12  # Jacobian MSM points a rank
CROSS_N = 1 << 19  # a rank's block of the 2^21 transform


@contextlib.contextmanager
def recorded_merges():
    """Copies of the operands of ops.curve_kernels.merge_pairs while in the
    block (parallel/sharded.py calls it through the module): a list of
    (curve, a, b), the first MERGE_KEEP calls of each curve and width."""
    from zelana_tpu_torch.ops import curve_kernels as CK

    calls, inner = [], CK.merge_pairs

    def merge_pairs(a, b, curve):
        if sum(c == curve and x.shape[1] == a.shape[1]
               for c, x, _ in calls) < MERGE_KEEP:
            calls.append((curve, a.clone(), b.clone()))
        return inner(a, b, curve)

    CK.merge_pairs = merge_pairs
    try:
        yield calls
    finally:
        CK.merge_pairs = inner


def check_merges(torch, calls, widths, what: str,
                 curves=("g1", "g2")) -> list:
    """merge_pairs against bucket_merge_plain (K = 2 over [a | b]) on each
    (curve, a, b) of `calls`, bit for bit; fails unless every curve of
    `curves` was held at every width of `widths`. Returns the (curve,
    width) held."""
    from zelana_tpu_torch.ops import curve_kernels as CK

    seen = set()
    for curve, a, b in calls:
        w = a.shape[1]
        dense = torch.arange(2 * w, dtype=torch.int32, device=a.device)
        want = CK.bucket_merge_plain(torch.cat([a, b], 1), dense, 2, curve,
                                     nb=w)
        if not torch.equal(CK.merge_pairs(a, b, curve), want):
            raise AssertionError(f"{what}: merge_pairs {curve} at width {w} "
                                 f"differs from bucket_merge_plain")
        seen.add((curve, w))
    missing = sorted({(c, w) for c in curves for w in widths} - seen)
    if missing:
        raise AssertionError(f"{what}: merge_pairs never ran at {missing}")
    return sorted(seen)


def _ntt_cross_kernel(torch, dev, rep) -> dict:
    """ntt_cross against ntt_cross_plain on a rank's block of the 2^21
    transform over four ranks (rank 1 at cross stage 1: the twiddle slice
    at m), both halves of the butterfly, with and without the final
    factor; timed on inputs rotated past the L2, beside its bound (96
    bytes read and 32 written an element, one product). Returns the
    kernels-line entry."""
    import numpy as np

    from zelana_tpu_torch.fields.bn254 import R as FR
    from zelana_tpu_torch.ops import limbs as L
    from zelana_tpu_torch.ops import ntt as NTT

    rng = np.random.default_rng(19)
    m = CROSS_N
    copies = [tuple(rand_words(torch, rng, FR >> 224, m, dev)
                    for _ in range(2)) for _ in range(2)]
    own, recv = copies[0]
    twst = rand_words(torch, rng, FR >> 224, MESH_NTT, dev)
    col0 = NTT.cross_twiddle_column(m, 1, 1)
    ek = L.encode_mont([pow(MESH_NTT, FR - 2, FR)], L.FR)[:, 0]
    err = 0
    for bit in (0, 1):
        for e in (None, ek):
            got = NTT.ntt_cross(own, recv, twst, col0, bit, e)
            want = NTT.ntt_cross_plain(own, recv, twst, col0, bit, e)
            mism, diff = compare(torch, got, want)
            log(f"  ntt_cross 2^19 bit {bit}{' with 1/n' if e is not None else ''}: "
                f"mismatches {mism}, max |diff| {diff}")
            if mism:
                raise AssertionError("ntt_cross differs from its plain "
                                     "version")
            err = max(err, diff)
    ms = cuda_ms(torch, rotating(
        lambda o, r: NTT.ntt_cross(o, r, twst, col0, 1), copies), 20)
    plain = cuda_ms(torch, lambda: NTT.ntt_cross_plain(own, recv, twst, col0,
                                                       1), 1, False)
    bms, by = bound_ms(128 * m, m * MUL_OPS)
    rep["ntt_cross_2_19"] = {"ms": ms, "plain_ms": plain, "bound_ms": bms,
                             "bound_by": by}
    log(f"  ntt_cross 2^19: {ms:.5f} ms by events (inputs rotated past the "
        f"L2), bound {bms:.5f} ms ({by}), {bms / ms:.1%} of it; plain "
        f"{plain:.1f} ms")
    return _entry("ntt_cross", "zelana_tpu_torch/csrc/ntt_kernels.cu",
                  "zelana_tpu/ops/pallas_field.py:136", err, ms, plain, bms,
                  by)


def mesh_backend(torch) -> str:
    """NCCL, rank r on card r, where the host has MESH_WORLD cards, else
    gloo on the one card (NCCL refuses two ranks on one card)."""
    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= MESH_WORLD else "gloo"
    log(f"mesh: {cards} card(s), so the {MESH_WORLD} ranks run over "
        f"{backend}")
    return backend


def phase_mesh(torch, dev, report, production=None) -> tuple:
    """Returns (ntt_cross's kernels-line entry, the launches of ntt_cross
    and jac_add, sharded_msm's combine, over the ranks' path, the launches
    of the BASELINE config 5 paths by field of the kernels line). Three
    run_local calls: the mesh checks (mesh_rank), the 2^24-point MSM
    (msm24_rank) and, with `production` (the production phase's prover
    and batch), its first chunk proved over the ranks (chunk_rank)."""
    from zelana_tpu_torch.parallel import distributed as D

    backend = mesh_backend(torch)
    rep = report["mesh"] = {"backend": backend}
    entry = _ntt_cross_kernel(torch, dev, rep)
    t0 = time.time()
    ranks = D.run_local(mesh_rank, MESH_WORLD, backend=backend, device="cuda",
                        args=(MESH_SEED,), timeout=600.0)
    rep["wall_s"] = time.time() - t0
    rep["ranks"] = ranks
    where = "one card" if backend == "gloo" else f"{MESH_WORLD} cards"
    log(f"mesh: {MESH_WORLD} ranks over {backend} on {where}, "
        f"{rep['wall_s']:.1f} s wall with their start-up; every check "
        f"passed on every rank, merge_pairs equal to bucket_merge_plain at "
        f"{ranks[0]['merges_held']}")
    for r in ranks:
        log(f"  rank {r['rank']} ({r['backend']}, {r['device']}): set-up "
            f"{r['setup_s']:.1f} s; path "
            f"{r['path_s']:.2f} s (under the profiler), device busy "
            f"{r['busy_ms']:.1f} ms, "
            f"collectives {1e3 * r['comm']['seconds']:.1f} ms host time, "
            f"{r['comm']['bytes'] / 2**20:.1f} MiB sent in "
            f"{r['comm']['calls']} calls; launches {r['launches']}")
        for name, t in r["times"].items():
            log(f"    {name}: {t['ms']:.1f} ms, of it collectives "
                f"{t['comm_ms']:.1f} ms")
    launches = {k: sum(r["launches"].get(k, 0) for r in ranks)
                for k in ("ntt_cross", "jac_add")}
    for k, v in launches.items():
        if v == 0:
            raise AssertionError(f"the mesh path launched no {k}")
    paths = {"mesh_msm_2_24_launches": _mesh_msm24(backend, rep)}
    if production is None:
        log("mesh: the production phase did not run, so its chunk is not "
            "proved over the ranks")
    else:
        paths["mesh_chunk_launches"] = _mesh_chunk(backend, *production, rep)
    return entry, launches, paths


def mesh_rank(mesh, seed: int) -> dict:
    """One rank of the `mesh` phase (spawned by run_local): the same inputs
    on every rank from `seed`, the multi-card path under torch.profiler
    with the launch counts set to 0 just before, then every answer against
    the one-card function or the closed form (a failed check fails the
    rank and the run)."""
    import numpy as np
    import torch

    from zelana_tpu_torch.curves.point_array import PointArray
    from zelana_tpu_torch.fields.bn254 import R as FR
    from zelana_tpu_torch.groth16.keys import ProvingKey
    from zelana_tpu_torch.hashes.mimc_batch import hash2_batch
    from zelana_tpu_torch.ops import cuda
    from zelana_tpu_torch.ops import msm as MJ
    from zelana_tpu_torch.ops import msm_scan as MSM
    from zelana_tpu_torch.ops import ntt as NTT
    from zelana_tpu_torch.parallel import sharded as SH
    from zelana_tpu_torch.runtime.chunk_prover import Groth16ChunkProver

    t_setup = time.time()
    dev, W = mesh.device, mesh.size
    rng = np.random.default_rng(seed)

    scan = {}
    for curve, comps in (("g1", 2), ("g2", 4)):
        tile = PointArray.from_points(_tile_points(curve), comps)
        idx = np.arange(W * MESH_SCAN) % MSM_TILE
        limbs = scalar_limbs(rng, W * MESH_SCAN)
        scan[curve] = (PointArray(tile.arr[idx], tile.inf[idx], comps), limbs,
                       tiled_want(curve, limbs))
    jac_pool = tiled_pool(torch, "g1", 0, W * MESH_JAC, dev)
    jac_limbs = scalar_limbs(rng, W * MESH_JAC)
    jac_digits = MSM.scalar_digits(jac_limbs)
    jac_want = tiled_want("g1", jac_limbs)
    x = rand_words(torch, rng, FR >> 224, MESH_NTT, dev)
    a, b = (rand_words(torch, rng, FR >> 224, MESH_MIMC, dev)
            for _ in range(2))
    plan = NTT.make_plan(MESH_NTT)
    plan.on(dev)
    with open("zelana_tpu_torch/testdata/chunk_101_d1_proof.json") as f:
        vec = json.load(f)
    prover = Groth16ChunkProver(
        ProvingKey.load_npz("artifacts/chunk_101_d1_pk.npz"), (1, 0, 1), 1,
        device=dev, mesh=mesh)
    chunk = dryrun_chunk()
    torch.cuda.synchronize()
    setup_s = time.time() - t_setup

    times = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        c0, t0 = mesh.comm["seconds"], time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = {"ms": 1e3 * (time.perf_counter() - t0),
                       "comm_ms": 1e3 * (mesh.comm["seconds"] - c0)}
        return out

    mesh.comm.update(seconds=0.0, bytes=0, calls=0)
    cuda.reset_launches()
    t_path = time.perf_counter()
    with profiled(torch) as prof, recorded_merges() as merges:
        got = {c: timed(f"sharded_msm_scan {c} {W} x 2^16",
                        lambda c=c: SH.sharded_msm_scan(
                            scan[c][0], scan[c][1], mesh, c))
               for c in ("g1", "g2")}
        fwd = timed("sharded_ntt 2^21", lambda: SH.sharded_ntt(x, plan, mesh))
        inv = timed("sharded_intt 2^21",
                    lambda: SH.sharded_intt(x, plan, mesh))
        hashed = timed("sharded_mimc_hash2 2^20",
                       lambda: SH.sharded_mimc_hash2(a, b, mesh))
        jac = timed(f"sharded_msm g1 {W} x 2^12",
                    lambda: SH.sharded_msm(jac_pool, jac_digits, mesh, "g1"))
        cp = timed("prove_chunk chunk_101_d1",
                   lambda: prover.prove_chunk(chunk, vec["batch_id"]))
        path_s = time.perf_counter() - t_path
    launches = {k: v for k, v in cuda.LAUNCHES.items() if v}
    busy = sum(e.self_device_time_total
               for e in device_events(prof, empty_ok=True)) / 1e3
    comm_total = dict(mesh.comm)

    for c in ("g1", "g2"):
        if got[c] != scan[c][2]:
            raise AssertionError(f"sharded_msm_scan {c} is wrong")
    m = MESH_NTT // W
    cols = slice(mesh.rank * m, (mesh.rank + 1) * m)
    if not torch.equal(fwd, NTT.ntt(x, plan)[:, cols]):
        raise AssertionError("sharded_ntt differs from the one-card ntt")
    if not torch.equal(inv, NTT.intt(x, plan)[:, cols]):
        raise AssertionError("sharded_intt differs from the one-card intt")
    if not torch.equal(hashed, hash2_batch(a, b)):
        raise AssertionError("sharded_mimc_hash2 differs from hash2_batch")
    if MJ._jac_to_affine_host(jac, "g1") != jac_want:
        raise AssertionError("sharded_msm is wrong")
    if cp.proof_bytes.hex() != vec["proof_bytes"]:
        raise AssertionError("the mesh chunk proof differs from the JAX "
                             "vector")
    # the reduction's exchanged halves, and each curve's first pair in
    # both orders at the full width
    first = {}
    for c, keep, recv in merges:
        first.setdefault((c, keep.shape[1]), (keep, recv))
    wide = [(c, torch.cat([k, r], 1), torch.cat([r, k], 1))
            for (c, w), (k, r) in first.items() if w == MSM_NB // 2]
    held = check_merges(torch, merges + wide,
                        [MSM_NB >> k for k in range(W.bit_length())],
                        f"rank {mesh.rank}")
    return {"rank": mesh.rank, "device": str(dev), "backend": mesh.backend,
            "setup_s": setup_s, "path_s": path_s,
            "busy_ms": busy, "times": times, "comm": comm_total,
            "launches": launches, "merges_held": held}


# ---------------------------------------------------------------------------
# BASELINE config 5: the 2^24-point MSM on one card (`msm24`) and over the
# ranks, and the production chunk proved over the ranks (`mesh`)
# ---------------------------------------------------------------------------

LONG_N = 1 << 24  # BASELINE.json configs[4]: a 2^24-point MSM
LONG_SEED = 24
# the host stages of a run-scan MSM: ops.msm_scan's functions, which
# msm_begin / msm_end and the sharded MSM reach through the module
LONG_HOST_CALLS = ("scalar_digits", "build_segment_schedules",
                   "upload_segment_schedules", "_finish_multi")


@functools.lru_cache(maxsize=None)
def long_want():
    """The closed form of the 2^24-point G1 MSM over the tiled pool with
    the scalars of LONG_SEED."""
    import numpy as np

    return tiled_want("g1", scalar_limbs(np.random.default_rng(LONG_SEED),
                                         LONG_N))


def rss_mib() -> float:
    """This process's resident set now (VmRSS), MiB."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024
    raise RuntimeError("no VmRSS in /proc/self/status")


@contextlib.contextmanager
def rss_peak(period: float = 0.05):
    """{"peak_mib": the largest rss_mib() sampled every `period` s on a
    thread while in the block}: a lower bound of the block's peak. Neither
    VmHWM (the chip host's kernel has none) nor getrusage's ru_maxrss (a
    spawned rank keeps its parent's peak across fork and exec) gives a
    rank's own peak."""
    out = {"peak_mib": rss_mib()}
    stop = threading.Event()

    def sample():
        while not stop.wait(period):
            out["peak_mib"] = max(out["peak_mib"], rss_mib())

    t = threading.Thread(target=sample, daemon=True)
    t.start()
    try:
        yield out
    finally:
        stop.set()
        t.join()
        out["peak_mib"] = max(out["peak_mib"], rss_mib())


def with_rss_peak(fn):
    """fn, its result dict given "peak_rss_mib": the sampled peak of the
    process's resident set over the call (rss_peak)."""
    @functools.wraps(fn)
    def call(*args, **kwargs):
        with rss_peak() as rss:
            out = fn(*args, **kwargs)
        out["peak_rss_mib"] = rss["peak_mib"]
        return out

    return call


@contextlib.contextmanager
def host_calls(module, names):
    """Seconds and calls of the functions `names` of `module` while in the
    block, for callers on one thread that reach them through the module:
    {name: [seconds, calls]}."""
    real = {n: getattr(module, n) for n in names}
    spent = {n: [0.0, 0] for n in names}

    def timed(name):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return real[name](*args, **kwargs)
            finally:
                spent[name][0] += time.perf_counter() - t0
                spent[name][1] += 1
        return call

    for n in names:
        setattr(module, n, timed(n))
    try:
        yield spent
    finally:
        for n, f in real.items():
            setattr(module, n, f)


def _host_stages(spent, begin_s: float, wall_s: float) -> dict:
    """Seconds of a run-scan MSM's host stages (host_calls over
    LONG_HOST_CALLS) and what is left of msm_begin (the dispatch loop,
    waiting on each segment past MAX_INFLIGHT) and of msm_end (the last
    fetches)."""
    s = {k: v[0] for k, v in spent.items()}
    return {"digits_s": s["scalar_digits"],
            "schedules_s": s["build_segment_schedules"],
            "uploads_s": s["upload_segment_schedules"],
            "dispatch_s": begin_s - s["scalar_digits"]
            - s["build_segment_schedules"] - s["upload_segment_schedules"],
            "finish_s": s["_finish_multi"],
            "fetch_s": wall_s - begin_s - s["_finish_multi"]}


def phase_msm24(torch, dev, report) -> dict:
    """BASELINE config 5 on one card: the 2^24-point G1 MSM through
    msm_scan.msm_begin / msm_end (256 segments of 2^16) over the tiled
    pool, against its closed form; the launches counted from 0 just before
    and read just after, the device's busy time under torch.profiler, the
    host stages' seconds, the peak device memory and the process's peak
    RSS; then the last segment's run-scans and bucket tail against their
    plain versions. Returns the launches."""
    import numpy as np

    from zelana_tpu_torch.ops import cuda
    from zelana_tpu_torch.ops import msm_scan as MSM

    rep = report["msm24"] = {}
    segments = -(-LONG_N // MSM.CHUNK_N)
    with rss_peak() as rss:
        t0 = time.time()
        limbs = scalar_limbs(np.random.default_rng(LONG_SEED), LONG_N)
        want = long_want()
        pool = tiled_pool(torch, "g1", 0, LONG_N, dev)
        torch.cuda.synchronize()
        rep["inputs_s"] = time.time() - t0
        torch.cuda.reset_peak_memory_stats()
        cuda.reset_launches()
        with host_calls(MSM, LONG_HOST_CALLS) as spent, \
                profiled(torch) as prof:
            t0 = time.time()
            handle = MSM.msm_begin((pool, np.zeros(LONG_N, bool), "g1"),
                                   limbs, "g1")
            begin_s = time.time() - t0
            got = MSM.msm_end(handle)
            wall_s = time.time() - t0
    launches = {k: v for k, v in cuda.LAUNCHES.items() if v}
    busy = _device_busy_ms(prof, "msm24")
    seen = sum(e.count for e in device_events(prof) if "_kernel" in e.key)
    rep.update(wall_s=wall_s, host=_host_stages(spent, begin_s, wall_s),
               busy_ms=busy, kernels_seen=seen, launches=launches,
               segments=segments,
               peak_device_bytes=torch.cuda.max_memory_allocated(),
               peak_rss_mib=rss["peak_mib"])
    log(f"msm24: {LONG_N} points G1, {segments} segments of "
        f"{MSM.CHUNK_N}: {wall_s:.2f} s wall (inputs {rep['inputs_s']:.2f} "
        f"s before it), host stages "
        + ", ".join(f"{k} {v:.2f}" for k, v in rep["host"].items())
        + f"; device busy {busy:.1f} ms ({busy / segments:.3f} ms a "
        f"segment; {seen} of {sum(launches.values())} kernels in the "
        f"profile); launches {launches}; peak device memory "
        f"{rep['peak_device_bytes'] / 2**30:.2f} GiB; peak RSS of the main "
        f"process {rep['peak_rss_mib']:.0f} MiB (sampled, inputs "
        f"included)")
    if got != want:
        raise AssertionError("the one-card 2^24 MSM differs from its "
                             "closed form")
    expect = {"runscan": 2 * segments, "bucket_tail": 2 * segments}
    if launches != expect:
        raise AssertionError(f"msm24 launched {launches}, not {expect}")
    log("msm24: equal to the closed form")
    lo = LONG_N - MSM.CHUNK_N
    rep["held_max_abs_err"] = hold_segment(
        torch, pool[:, lo:], segment_schedule(limbs[lo:], dev), "g1",
        "msm24 last segment")
    del pool, handle
    torch.cuda.empty_cache()
    return launches


def _rank_line(r) -> str:
    return (f"  rank {r['rank']} ({r['backend']}, {r['device']}): set-up "
            f"{r['setup_s']:.1f} s, {r['wall_s']:.2f} s wall, device busy "
            f"{r['busy_ms']:.1f} ms, collectives "
            f"{1e3 * r['comm']['seconds']:.1f} ms host time, "
            f"{r['comm']['bytes'] / 2**20:.2f} MiB sent in "
            f"{r['comm']['calls']} calls; launches {r['launches']}; peak "
            f"device memory {r['peak_device_bytes'] / 2**30:.2f} GiB, peak "
            f"RSS {r['peak_rss_mib']:.0f} MiB")


def _sum_launches(ranks) -> dict:
    out = {}
    for r in ranks:
        for k, v in r["launches"].items():
            out[k] = out.get(k, 0) + v
    return out


def merge_widths(world: int, segments: int) -> list:
    """The widths merge_pairs runs at in a sharded run-scan MSM: 8,192 where
    a shard has more than one segment (their fold), then the reduction's
    halves."""
    return ([MSM_NB] if segments > 1 else []) + [
        MSM_NB >> k for k in range(1, world.bit_length())]


def _mesh_msm24(backend: str, rep) -> dict:
    """The 2^24-point G1 MSM over MESH_WORLD ranks (msm24_rank), every
    rank's answer against the closed form. Returns the ranks' launches."""
    from zelana_tpu_torch.parallel import distributed as D

    want = long_want()
    t0 = time.time()
    with rss_peak() as rss:
        ranks = D.run_local(msm24_rank, MESH_WORLD, backend=backend,
                            device="cuda", args=(want, LONG_N, None),
                            timeout=900.0)
    out = rep["msm_2_24"] = {"wall_s": time.time() - t0, "ranks": ranks,
                             "main_peak_rss_mib": rss["peak_mib"]}
    log(f"mesh 2^24 MSM: {MESH_WORLD} ranks over {backend}, "
        f"{out['wall_s']:.1f} s wall with their start-up, "
        f"{ranks[0]['segments']} segments of a {ranks[0]['shard']}-point "
        f"shard a rank; every rank equal to the closed form; merge_pairs "
        f"equal to bucket_merge_plain at {ranks[0]['merges_held']}; peak RSS "
        f"of the main process meanwhile {rss['peak_mib']:.0f} MiB")
    for r in ranks:
        log(_rank_line(r) + "; host stages " + ", ".join(
            f"{k} {v:.2f}" for k, v in r["host"].items()))
    return _sum_launches(ranks)


@with_rss_peak
def msm24_rank(mesh, want, n: int, chunk_n) -> dict:
    """One rank of the 2^24-point G1 MSM over the ranks (spawned by
    run_local): all n scalars from LONG_SEED and this rank's shard of the
    tiled pool, then msm_begin_sharded (chunk_n points a segment,
    msm_scan.CHUNK_N for None; the segments added up on the card, then two
    exchanges at four ranks) and msm_end, with the launch counts set to 0
    just before, under torch.profiler; the answer against `want`, the
    closed form; merge_pairs against bucket_merge_plain on the arrays it
    added (the segments' fold at 8,192, the reduction at 4,096 and 2,048);
    rank 0 also holds its last segment's run-scans and bucket tail."""
    import numpy as np
    import torch

    from zelana_tpu_torch.ops import cuda
    from zelana_tpu_torch.ops import msm_scan as MSM
    from zelana_tpu_torch.parallel import sharded as SH

    t0 = time.time()
    W, chunk = mesh.size, chunk_n or MSM.CHUNK_N
    limbs = scalar_limbs(np.random.default_rng(LONG_SEED), n)
    shard, lo, hi = SH._shard_range(n, mesh)
    pool = tiled_pool(torch, "g1", lo, lo + shard, mesh.device)
    prep = SH.ShardedPool(pool, np.zeros(n, bool), "g1", n, shard)
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    torch.cuda.reset_peak_memory_stats()
    mesh.comm.update(seconds=0.0, bytes=0, calls=0)
    cuda.reset_launches()
    with host_calls(MSM, LONG_HOST_CALLS) as spent, profiled(torch) as prof, \
            recorded_merges() as merges:
        t0 = time.perf_counter()
        handle = SH.msm_begin_sharded(prep, limbs, mesh, chunk_n=chunk_n)
        begin_s = time.perf_counter() - t0
        got = MSM.msm_end(handle)
        wall_s = time.perf_counter() - t0
    launches = {k: v for k, v in cuda.LAUNCHES.items() if v}
    busy = sum(e.self_device_time_total
               for e in device_events(prof, empty_ok=True)) / 1e3
    peak = torch.cuda.max_memory_allocated()
    if got != want:
        raise AssertionError(f"rank {mesh.rank}: the sharded 2^24 MSM "
                             f"differs from its closed form")
    segments = -(-shard // chunk)
    # a merge a segment, a merge_pairs a further segment and a reduction
    # step, the tree
    expect = {"runscan": 2 * segments,
              "bucket_tail": 2 * segments + W.bit_length() - 1}
    if launches != expect:
        raise AssertionError(f"rank {mesh.rank} launched {launches}, not "
                             f"{expect}")
    held = check_merges(torch, merges, merge_widths(W, segments),
                        f"rank {mesh.rank}", curves=("g1",))
    err = 0
    if mesh.rank == 0:
        s_lo = (segments - 1) * chunk
        err = hold_segment(
            torch, pool[:, s_lo:],
            segment_schedule(limbs[lo + s_lo:hi], mesh.device), "g1",
            "rank 0's last segment")
    return {"rank": mesh.rank, "device": str(mesh.device),
            "backend": mesh.backend, "setup_s": setup_s, "wall_s": wall_s,
            "host": _host_stages(spent, begin_s, wall_s), "busy_ms": busy,
            "comm": dict(mesh.comm), "launches": launches,
            "peak_device_bytes": peak, "merges_held": held,
            "segments": segments, "shard": shard,
            "held_max_abs_err": err}


def _mesh_chunk(backend: str, prover, batch, rep) -> dict:
    """The production phase's first chunk proved over MESH_WORLD ranks
    (chunk_rank): its key handed over through ProvingKey.save_npz in a
    temporary directory, the chunk through run_local's arguments; every
    rank's proof byte-equal to the one-card proof. Returns the ranks'
    launches."""
    import tempfile

    from zelana_tpu_torch.parallel import distributed as D

    chunk, want = batch["chunks"][0], batch["proofs"][0]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "production_pk.npz")
        t0 = time.time()
        prover.pk.save_npz(path)
        save_s = time.time() - t0
        size = os.path.getsize(path)
        t0 = time.time()
        with rss_peak() as rss:
            ranks = D.run_local(
                chunk_rank, MESH_WORLD, backend=backend, device="cuda",
                args=(path, prover.capacity, prover.tree_depth, chunk,
                      PRODUCTION_BATCH, want.proof_bytes.hex()),
                timeout=900.0)
        wall = time.time() - t0
    rep["production_chunk"] = {"key_save_s": save_s, "key_bytes": size,
                               "wall_s": wall, "ranks": ranks,
                               "main_peak_rss_mib": rss["peak_mib"]}
    r0 = ranks[0]
    log(f"mesh production chunk: key saved in {save_s:.1f} s "
        f"({size / 2**20:.0f} MiB); {MESH_WORLD} ranks over {backend}, "
        f"{wall:.1f} s wall with their start-up; shards {r0['shards']}, "
        f"segments {r0['segments']}; every rank's proof byte-equal to the "
        f"one-card proof and verified; merge_pairs equal to "
        f"bucket_merge_plain at {r0['merges_held']}; peak RSS of the main "
        f"process meanwhile {rss['peak_mib']:.0f} MiB")
    for r in ranks:
        log(_rank_line(r) + f"; key load {r['load_s']:.1f} s, pools "
            f"{r['pools_s']:.1f} s, verify {r['verify_s']:.1f} s")
    log("  rank 0's prove, its phases:")
    for at, name, ms, thread in r0["phases"]:
        log(f"    [+{at:8.3f} s] {name:22s} {ms:10.1f} ms  {thread}")
    return _sum_launches(ranks)


@with_rss_peak
def chunk_rank(mesh, key_path: str, capacity, depth: int, chunk,
               batch_id: int, want_hex: str) -> dict:
    """One rank of the production chunk proved over the ranks (spawned by
    run_local): the key loaded from key_path, this rank's shards of its
    query pools, then prove_chunks([chunk], batch_id) through the mesh
    with the launch counts set to 0 just before, under torch.profiler; the
    proof byte-equal to want_hex (the one-card proof) and verified;
    merge_pairs against bucket_merge_plain on the arrays it added."""
    import torch

    from zelana_tpu_torch.groth16.keys import ProvingKey, prepare_queries
    from zelana_tpu_torch.ops import cuda
    from zelana_tpu_torch.ops import msm_scan as MSM
    from zelana_tpu_torch.runtime.chunk_prover import Groth16ChunkProver

    t0 = time.time()
    pk = ProvingKey.load_npz(key_path)
    load_s = time.time() - t0
    W = mesh.size
    prover = Groth16ChunkProver(pk, capacity, depth, device=mesh.device,
                                mesh=mesh)
    t0 = time.time()
    pools = prepare_queries(pk, mesh.device, mesh)
    torch.cuda.synchronize()
    pools_s = time.time() - t0
    shards = {k: p.shard for k, p in pools.items()}
    torch.cuda.reset_peak_memory_stats()
    mesh.comm.update(seconds=0.0, bytes=0, calls=0)
    cuda.reset_launches()
    with profiled(torch) as prof, recorded_merges() as merges:
        since = time.perf_counter()
        t0 = time.time()
        cp = prover.prove_chunks([chunk], batch_id)[0]
        torch.cuda.synchronize()
        wall_s = time.time() - t0
        phases = _phases(since, show=False)
    launches = {k: v for k, v in cuda.LAUNCHES.items() if v}
    busy = sum(e.self_device_time_total
               for e in device_events(prof, empty_ok=True)) / 1e3
    peak = torch.cuda.max_memory_allocated()
    if cp.proof_bytes.hex() != want_hex:
        raise AssertionError(f"rank {mesh.rank}: the mesh proof differs from "
                             f"the one-card proof")
    t0 = time.time()
    if not prover.verify_chunk(cp):
        raise AssertionError(f"rank {mesh.rank}: the mesh proof does not "
                             f"verify")
    verify_s = time.time() - t0
    segments = {k: -(-v // MSM.CHUNK_N) for k, v in shards.items()}
    expect = {"ntt_pass": 21, "runscan": 2 * sum(segments.values()),
              "bucket_tail": sum(2 * s + W.bit_length() - 1
                                 for s in segments.values())}
    if launches != expect:
        raise AssertionError(f"rank {mesh.rank} launched {launches}, not "
                             f"{expect}")
    held = check_merges(torch, merges,
                        merge_widths(W, max(segments.values())),
                        f"rank {mesh.rank}")
    return {"rank": mesh.rank, "device": str(mesh.device),
            "backend": mesh.backend, "setup_s": load_s + pools_s,
            "load_s": load_s, "pools_s": pools_s, "wall_s": wall_s,
            "verify_s": verify_s, "busy_ms": busy, "comm": dict(mesh.comm),
            "launches": launches, "peak_device_bytes": peak,
            "merges_held": held,
            "shards": shards, "segments": segments, "phases": phases}


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


def _phases(since: float, show: bool = True) -> list:
    """Return (and log, with `show`) the spans (zelana_tpu_torch.trace)
    that started at or after `since` (time.perf_counter()), in the order
    they ended: (seconds from `since` to the span's end, name, ms, thread
    name)."""
    from zelana_tpu_torch import trace

    out = [(round(r.end - since, 3), r.name, round(1e3 * (r.end - r.start), 3),
            r.thread_name) for r in trace.spans() if r.start >= since]
    for at, name, ms, thread in out if show else ():
        log(f"  [+{at:8.3f} s] {name:22s} {ms:10.1f} ms  {thread}")
    return out


if __name__ == "__main__":
    sys.exit(main())
