#!/usr/bin/env python3
"""Team-size sweep of the Jacobian MSM's kernels (csrc/jac_kernels.cu) on
one CUDA card.

    python3 tools/jac_teams.py              # from the repo root
    python3 tools/jac_teams.py --variants 32/1/3/5/15,64/1/3/5/15

A variant is A/G1/G2/C1/C2 (the first of the default list is the
build's own): the adds a block of the scan and batch-add kernels
(SCAN_ADDS), their team sizes for G1 and G2 (Team<Fq>::SCAN,
Team<Fq2>::SCAN), and the team sizes of the bucket reduction and Horner
(Team<Fq>::CHAIN, Team<Fq2>::CHAIN), all constants of jac_kernels.cu.
This writes a copy of jac_kernels.cu with a variant's values into
build/jac_teams/ and builds it (one nvcc each, all started together,
with the port's flags), then, for G1 and G2: the batch add over 2^20
lanes of random words (the scan step's shape, by CUDA events), one
bucket reduction of 16 windows with all 255 buckets filled (a launch, by
CUDA events) and Horner over 32 windows; each output held to the
default build's (the wrappers of ops/curve_ops.py), and the default
build's held to the plain versions (the batch add on its first 2^16
lanes). Prints the card's name and power limit, each build's ptxas lines
and one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import cuda_ms, rand_words  # noqa: E402

VARIANTS = "32/1/6/5/15,32/1/3/5/15,32/2/12/5/15,64/1/6/5/15,32/1/6/3/9"
LANES = 1 << 20
WINDOWS = 16


def build(variants) -> dict:
    """{variant: (library path, ptxas lines of the jac kernels)}."""
    from zelana_tpu_torch.ops import cuda

    out_dir = os.path.join(ROOT, "build", "jac_teams")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(cuda.CSRC, "jac_kernels.cu")) as f:
        text = f.read()
    procs = {}
    for v in variants:
        a, t1, t2, c1, c2 = v.split("/")
        src, n = re.subn(r"constexpr int SCAN_ADDS = \d+;",
                         f"constexpr int SCAN_ADDS = {a};", text)
        teams = iter([(t1, c1), (t2, c2)])  # Team<Fq>, then Team<Fq2>
        src, m = re.subn(r"SCAN = \d+, CHAIN = \d+;",
                         lambda _: "SCAN = {}, CHAIN = {};".format(
                             *next(teams)), src)
        if (n, m) != (1, 2):
            raise RuntimeError("jac_kernels.cu: SCAN_ADDS or the Team<> "
                               "sizes not found")
        tag = v.replace("/", "_")
        cu = os.path.join(out_dir, f"jac_kernels_{tag}.cu")
        with open(cu, "w") as f:
            f.write(src)
        lib = os.path.join(out_dir, f"libjac_{tag}.so")
        cmd = [cuda._nvcc(), *cuda.NVCC_FLAGS, f"-I{cuda.CSRC}", "-o", lib,
               cu]
        procs[v] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    lib)
    cuda.build_all()  # the default build, meanwhile
    libs = {}
    for v, (proc, lib) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc, variant {v}:\n{text}")
        ptxas, kernel = [], ""
        for ln in text.splitlines():
            if "Compiling" in ln:
                kernel = ln.split("'")[1] if "'" in ln else ln
            elif kernel and ("spill" in ln or "Used" in ln):
                ptxas.append(f"{kernel}: "
                             + ln.replace("ptxas info    :", "").strip())
        libs[v] = (lib, ptxas)
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=VARIANTS,
                    help="comma-separated A/G1/G2/C1/C2 team settings")
    args = ap.parse_args()
    variants = args.variants.split(",")
    import numpy as np
    import torch

    from zelana_tpu_torch.fields.bn254 import P
    from zelana_tpu_torch.ops import cuda
    from zelana_tpu_torch.ops import curve_kernels as CK
    from zelana_tpu_torch.ops import curve_ops as CO

    if not torch.cuda.is_available():
        raise SystemExit("jac_teams: no CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    libs = build(variants)
    for v, (_, ptxas) in libs.items():
        for ln in ptxas:
            print(f"ptxas {v}: {ln}", flush=True)
    rng = np.random.default_rng(23)
    out = {"card": smi}
    for curve in ("g1", "g2"):
        C, cid = CK.rows(curve), 0 if curve == "g1" else 1

        def words(n):
            return torch.cat([rand_words(torch, rng, P >> 224, n, dev)
                              for _ in range(C // 8)])

        p, q = words(LANES), words(LANES)
        vals = words(WINDOWS * 256).view(C, WINDOWS, 256)
        ends = torch.arange(WINDOWS * 256, dtype=torch.int32,
                            device=dev).view(WINDOWS, 256)
        tot = words(32)
        want_add = CO.jac_add(p, q, curve)
        want_red = CO.jac_bucket_reduce(
            vals, ends, torch.empty((C, WINDOWS), dtype=torch.int32,
                                    device=dev), curve)
        want_hor = CO.jac_horner(tot, curve)
        n = 1 << 16
        plain = {
            "add": torch.equal(want_add[:, :n], CO.jac_add_plain(
                p[:, :n], q[:, :n], curve)),
            "reduce": torch.equal(want_red, CO.jac_bucket_reduce_plain(
                vals, ends, curve)),
            "horner": torch.equal(want_hor, CO.jac_horner_plain(tot, curve))}
        print(f"{curve}: default build against the plain versions {plain}",
              flush=True)
        if not all(plain.values()):
            raise AssertionError(f"{curve}: the kernels differ from their "
                                 f"plain versions")
        stream = torch.cuda.current_stream(dev).cuda_stream
        for v, (path, _) in libs.items():
            lib = ctypes.CDLL(path)
            cuda._declare(lib)
            got = torch.empty_like(want_add)
            red = torch.empty_like(want_red)
            hor = torch.empty_like(want_hor)

            def add():
                return lib.zt_jac_add(cid, p.data_ptr(), LANES, q.data_ptr(),
                                      LANES, got.data_ptr(), LANES, stream)

            def reduce():
                return lib.zt_jac_reduce(cid, vals.data_ptr(), vals[0].numel(),
                                         ends.data_ptr(), WINDOWS,
                                         red.data_ptr(), WINDOWS, stream)

            def horner():
                return lib.zt_jac_horner(cid, tot.data_ptr(), 32, 32,
                                         hor.data_ptr(), stream)

            for fn in (add, reduce, horner):
                if fn() != 0:
                    raise RuntimeError(f"{v} {curve}: {fn.__name__} failed")
            torch.cuda.synchronize()
            same = [torch.equal(got, want_add), torch.equal(red, want_red),
                    torch.equal(hor, want_hor)]
            if not all(same):
                raise AssertionError(f"{v} {curve}: differs from the default "
                                     f"build (add, reduce, horner: {same})")
            rec = {"add_2_20_ms": cuda_ms(torch, add, 5),
                   "reduce_16_ms": cuda_ms(torch, reduce, 5),
                   "horner_32_ms": cuda_ms(torch, horner, 5)}
            out[f"{curve} {v}"] = rec
            print(f"{curve} {v}: {json.dumps(rec)}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
