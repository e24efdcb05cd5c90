#!/usr/bin/env python3
"""Time two checkouts of the PyTorch/H100 port on one card, in turns.

    python3 tools/port_ab.py --parent build/parent   # from the repo root
    python3 tools/port_ab.py --parent build/parent --parts inversion
    python3 tools/port_ab.py --parent build/parent --parts hashes
    python3 tools/port_ab.py --parent build/parent --parts jac

Runs the parent checkout, this one, this one again and the parent again
(each in its own process, which builds that checkout's kernels into its own
build/ directory), and prints each run's device times as one JSON line,
then each side's mean. What it times, with CUDA events, on inputs made
from a fixed seed (`--parts`, default all):

  - keygen: fixed_base._run_fb on one FB_CHUNK-scalar chunk, G1 and G2
    (the step launches of one chunk, table head upload excluded);
  - msm: one full 2^16-point MSM segment per curve (msm_scan._device_msm
    over a pool that tiles 4,096 multiples of the generator), and its two
    run-scan passes alone; the segment less its scans is its tail;
  - inversion: limbs.mont_inv on 1,024 Fr elements (the recursion's base
    kernel), field_kernels.inv_fwd and inv_bwd at the three levels of a
    2^20 inversion (2^20, 2^16 and 4,096 elements, Fr), by device time
    (torch.profiler), and limbs.mont_batch_inv_nested at 2^20, Fr and Fq,
    by CUDA events (the launches' gaps included) and by device time;
  - ntt: groth16.prove.witness_map at 2^13 (the L2 prove's domain) and
    2^21 (the production chunk's) by CUDA events and by device time, its
    device kernels and the port's launches a call; ntt.ntt, intt,
    coset_ntt and coset_intt at 2^13 by device time (50 calls a window,
    the device kernels seen a call beside: the profiler can drop a
    window's first kernels) and at 2^21 by CUDA events; and the device
    time of a one-element fill, the floor of any launch;
  - hashes: hashes.poseidon_batch.poseidon_hash_batch over two columns,
    BN254 8/56 at 2^15 and BN254 8/57 / BLS12-381 8/57 at 2^12, by CUDA
    events (the host's launch gaps included), and the port's launches a
    call;
  - jac: ops.msm._msm, the Jacobian windowed MSM, at 2^16 points per curve
    (a pool that tiles 4,096 multiples of the generator, scalars below
    2^253), by the host clock around a synchronized call, by CUDA events
    over back-to-back calls and by device time, and the port's launches
    a call.

Both checkouts must expose those functions with the same signatures.
"""

import argparse
import json
import os
import subprocess
import sys

# the device-time helpers of chip_smoke.py beside this checkout's root, one
# rule for a profiler window that dropped kernels in both scripts; a
# measured checkout's package comes first on sys.path (measure)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import cuda_ms, device_ms, device_profile  # noqa: E402

ORDER = ("parent", "change", "change", "parent")


PARTS = ("keygen", "msm", "inversion", "ntt", "hashes", "jac")


def measure(root: str, parts) -> dict:
    """Device times of one checkout, imported from `root`."""
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    from zelana_tpu_torch.curves import g1 as G1, g2 as G2
    from zelana_tpu_torch.fields.bn254 import R as FR
    from zelana_tpu_torch.ops import curve_kernels as CK
    from zelana_tpu_torch.ops import fixed_base as FB
    from zelana_tpu_torch.ops import limbs as L
    from zelana_tpu_torch.ops import msm_scan as MSM
    from zelana_tpu_torch.r1cs.native_synth import fr_array, words32

    if not torch.cuda.is_available():
        raise SystemExit("port_ab: no CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    out = {}
    if "inversion" in parts:
        out.update(measure_inversion(torch, np, dev))
    if "ntt" in parts:
        out.update(measure_ntt(torch, np, dev))
    if "hashes" in parts:
        out.update(measure_hashes(torch, np, dev))
    if "jac" in parts:
        out.update(measure_jac(torch, np, dev))
    if "keygen" not in parts and "msm" not in parts:
        out["device"] = torch.cuda.get_device_name(0)
        return out
    scalars = [int.from_bytes(rng.bytes(32), "little") % FR
               for _ in range(FB.FB_CHUNK)]
    words = L.to_tensor(words32(fr_array(scalars)), dev)
    n = MSM.CHUNK_N
    limbs = rng.integers(0, 1 << 63, size=(n, 4), dtype=np.uint64)
    limbs[:, 3] >>= np.uint64(2)
    d = MSM._upload(MSM.build_schedule(MSM.scalar_digits(limbs)), dev)
    for curve, G, prep_fb, prep in (
            ("g1", G1, FB.prepare_table_g1, MSM.prepare_g1),
            ("g2", G2, FB.prepare_table_g2, MSM.prepare_g2)):
        if "keygen" in parts:
            head = prep_fb(G.generator(), dev)[1]
            out[f"keygen_chunk_{curve}_ms"] = cuda_ms(
                torch, lambda: FB._run_fb(head, words, curve), 5)
        if "msm" not in parts:
            continue
        pts, acc = [], G.generator()
        for _ in range(4096):
            pts.append(acc)
            acc = G.add(acc, G.generator())
        pool = prep(pts, dev)[0].repeat(1, n // 4096).contiguous()
        C = CK.rows(curve)
        emit = CK.runscan(pool, d["pid"], d["flag"], curve)
        scans = cuda_ms(torch, lambda: CK.runscan(
            emit.view(C, -1), d["pos2"], d["flag2"], curve, True), 10)
        scans += cuda_ms(torch, lambda: CK.runscan(pool, d["pid"], d["flag"],
                                                   curve), 10)
        seg = cuda_ms(torch, lambda: MSM._device_msm(pool, d, curve), 10)
        out[f"segment_{curve}_ms"] = seg
        out[f"scans_{curve}_ms"] = scans
        out[f"tail_{curve}_ms"] = seg - scans
    out["device"] = torch.cuda.get_device_name(0)
    return out


def rand_words(torch, np, rng, spec, n, dev):
    """(8, n) int32 words of random canonical elements of `spec`."""
    w = rng.integers(0, 1 << 32, size=(8, n), dtype=np.uint64)
    w[7] %= spec.modulus >> 224
    return torch.from_numpy(w.astype(np.uint32).view(np.int32)).to(dev)


def measure_inversion(torch, np, dev) -> dict:
    """The batch inversion's kernels through functions both checkouts
    expose; random canonical words from a fixed seed."""
    from zelana_tpu_torch.ops import field_kernels as FK
    from zelana_tpu_torch.ops import limbs as L

    rng = np.random.default_rng(6)

    def words(spec, n):
        return rand_words(torch, np, rng, spec, n, dev)

    out = {}
    base = words(L.FR, FK.INV_BLOCK)
    out["inv_base_1024_device_ms"] = device_ms(
        torch, lambda: L.mont_inv(base, L.FR), 20)
    for n in (1 << 20, 1 << 16, 4096):
        a = words(L.FR, n)
        out[f"inv_fwd_{n}_device_ms"] = device_ms(
            torch, lambda: FK.inv_fwd(a, L.FR), 20)
        pre, tot = FK.inv_fwd(a, L.FR)
        tinv = words(L.FR, tot.shape[1])
        out[f"inv_bwd_{n}_device_ms"] = device_ms(
            torch, lambda: FK.inv_bwd(a, pre, tinv, L.FR), 20)
    for spec, name in ((L.FR, "fr"), (L.FQ, "fq")):
        a = words(spec, 1 << 20)
        out[f"batch_inv_{name}_2_20_ms"] = cuda_ms(
            torch, lambda: L.mont_batch_inv_nested(a, spec), 20)
        out[f"batch_inv_{name}_2_20_device_ms"] = device_ms(
            torch, lambda: L.mont_batch_inv_nested(a, spec), 20)
    return out


def measure_ntt(torch, np, dev) -> dict:
    """The witness map and its four transforms through functions both
    checkouts expose; random canonical words from a fixed seed."""
    from zelana_tpu_torch.groth16.prove import witness_map
    from zelana_tpu_torch.ops import cuda
    from zelana_tpu_torch.ops import limbs as L
    from zelana_tpu_torch.ops import ntt as NTT

    rng = np.random.default_rng(8)
    out = {}
    one = torch.zeros(1, dtype=torch.int32, device=dev)
    out["fill_1_device_ms"] = device_ms(torch, one.zero_, 50)
    for log_n, reps in ((13, 50), (21, 10)):
        n = 1 << log_n
        plan = NTT.make_plan(n)
        evals = [rand_words(torch, np, rng, L.FR, n, dev) for _ in range(3)]
        for name in ("ntt", "intt", "coset_ntt", "coset_intt"):
            f = getattr(NTT, name)
            key = f"{name}_2_{log_n}"
            if log_n == 21:
                out[f"{key}_ms"] = cuda_ms(torch, lambda: f(evals[0], plan),
                                           reps)
                continue
            ms, kernels, _ = device_profile(
                torch, lambda: f(evals[0], plan), reps)
            out[f"{key}_device_ms"] = ms
            out[f"{key}_device_kernels"] = kernels
        wm = lambda: witness_map(evals, plan)  # noqa: E731
        out[f"witness_map_2_{log_n}_ms"] = cuda_ms(torch, wm, reps)
        ms, kernels, _ = device_profile(torch, wm, reps)
        out[f"witness_map_2_{log_n}_device_ms"] = ms
        out[f"witness_map_2_{log_n}_device_kernels"] = kernels
        torch.cuda.synchronize()
        cuda.reset_launches()
        wm()
        torch.cuda.synchronize()
        out[f"witness_map_2_{log_n}_launches"] = sum(cuda.LAUNCHES.values())
        del evals
    return out


def measure_hashes(torch, np, dev) -> dict:
    """The batched Poseidon hash through the function both checkouts
    expose; random canonical words from a fixed seed."""
    from zelana_tpu_torch.hashes import poseidon as P
    from zelana_tpu_torch.hashes import poseidon_batch as PB
    from zelana_tpu_torch.ops import cuda
    from zelana_tpu_torch.ops import limbs as L

    rng = np.random.default_rng(9)
    out = {}
    for key, cfg, n in (("bn254_8_56_2_15", P.bn254_config(), 1 << 15),
                        ("bn254_8_57_2_12", P.bn254_config_57(), 1 << 12),
                        ("bls12_381_8_57_2_12", P.bls12_381_config(),
                         1 << 12)):
        cols = [rand_words(torch, np, rng, L.FieldSpec(cfg.modulus), n, dev)
                for _ in range(2)]
        fn = lambda: PB.poseidon_hash_batch(cfg, cols)  # noqa: E731
        out[f"poseidon_{key}_ms"] = cuda_ms(torch, fn, 5)
        torch.cuda.synchronize()
        cuda.reset_launches()
        fn()
        torch.cuda.synchronize()
        out[f"poseidon_{key}_launches"] = sum(cuda.LAUNCHES.values())
    return out


def measure_jac(torch, np, dev) -> dict:
    """The Jacobian MSM through the function both checkouts expose, on
    inputs from a fixed seed."""
    import time

    from zelana_tpu_torch.curves import g1 as G1, g2 as G2
    from zelana_tpu_torch.ops import cuda
    from zelana_tpu_torch.ops import msm as JM
    from zelana_tpu_torch.ops import msm_scan as MSM

    rng = np.random.default_rng(7)
    n = MSM.CHUNK_N
    limbs = rng.integers(0, 1 << 63, size=(n, 4), dtype=np.uint64)
    limbs[:, 3] >>= np.uint64(2)
    digits = MSM.scalar_digits(limbs)
    out = {}
    for curve, G, prep in (("g1", G1, MSM.prepare_g1),
                           ("g2", G2, MSM.prepare_g2)):
        pts, acc = [], G.generator()
        for _ in range(4096):
            pts.append(acc)
            acc = G.add(acc, G.generator())
        pool = prep(pts, dev)[0].repeat(1, n // 4096).contiguous()
        fn = lambda: JM._msm(pool, digits, curve)  # noqa: E731
        fn()
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
        out[f"jac_msm_{curve}_wall_ms"] = min(walls)
        out[f"jac_msm_{curve}_events_ms"] = cuda_ms(torch, fn, 3)
        out[f"jac_msm_{curve}_device_ms"] = device_ms(torch, fn, 2)
        torch.cuda.synchronize()
        cuda.reset_launches()
        fn()
        torch.cuda.synchronize()
        out[f"jac_msm_{curve}_launches"] = sum(cuda.LAUNCHES.values())
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="checkout of the parent commit")
    ap.add_argument("--parts", default=",".join(PARTS),
                    help="comma-separated subset of " + ",".join(PARTS))
    ap.add_argument("--root", help=argparse.SUPPRESS)  # one measuring run
    args = ap.parse_args()
    parts = args.parts.split(",")
    if set(parts) - set(PARTS):
        ap.error(f"unknown part in {parts}")
    if args.root:
        print(json.dumps(measure(args.root, parts)), flush=True)
        return 0
    if not args.parent:
        ap.error("--parent is required")
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    runs = {"parent": [], "change": []}
    for side in ORDER:
        root = os.path.abspath(args.parent) if side == "parent" else here
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--root", root, "--parts", args.parts],
                             capture_output=True,
                             text=True, cwd=root)
        if res.returncode != 0:
            print(res.stdout, res.stderr, file=sys.stderr)
            return res.returncode
        rec = json.loads(res.stdout.strip().splitlines()[-1])
        runs[side].append(rec)
        print(json.dumps({"side": side, **rec}), flush=True)
    mean = {side: {k: sum(r[k] for r in recs) / len(recs)
                   for k in recs[0] if k != "device"}
            for side, recs in runs.items()}
    print(json.dumps({"mean": mean}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
