#!/usr/bin/env python3
"""Time two checkouts of the PyTorch/H100 port on one card, in turns.

    python3 tools/port_ab.py --parent build/parent   # from the repo root
    python3 tools/port_ab.py --parent build/parent --parts inversion

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
    kernel), field_kernels.inv_bwd at the three levels of a 2^20
    inversion (2^20, 2^16 and 4,096 elements, Fr), by device time
    (torch.profiler), and limbs.mont_batch_inv_nested at 2^20, Fr and Fq,
    by CUDA events (the launches' gaps included) and by device time.

Both checkouts must expose those functions with the same signatures.
"""

import argparse
import json
import os
import subprocess
import sys

ORDER = ("parent", "change", "change", "parent")


def cuda_ms(torch, fn, reps: int) -> float:
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


PARTS = ("keygen", "msm", "inversion")


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


def device_ms(torch, fn, reps: int) -> float:
    """Mean device time per run of fn's kernels (torch.profiler's device
    events): at the inversion's small levels CUDA events around
    back-to-back calls time the host's launches, not the kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type != DeviceType.CPU) / 1e3 / reps


def measure_inversion(torch, np, dev) -> dict:
    """The batch inversion's kernels through functions both checkouts
    expose; random canonical words from a fixed seed."""
    from zelana_tpu_torch.ops import field_kernels as FK
    from zelana_tpu_torch.ops import limbs as L

    rng = np.random.default_rng(6)

    def words(spec, n):
        w = rng.integers(0, 1 << 32, size=(8, n), dtype=np.uint64)
        w[7] %= spec.modulus >> 224
        return torch.from_numpy(w.astype(np.uint32).view(np.int32)).to(dev)

    out = {}
    base = words(L.FR, FK.INV_BLOCK)
    out["inv_base_1024_device_ms"] = device_ms(
        torch, lambda: L.mont_inv(base, L.FR), 20)
    for n in (1 << 20, 1 << 16, 4096):
        a = words(L.FR, n)
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
