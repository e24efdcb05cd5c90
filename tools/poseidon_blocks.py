#!/usr/bin/env python3
"""Block-size sweep of poseidon_kernel on one CUDA card.

    python3 tools/poseidon_blocks.py            # from the repo root
    python3 tools/poseidon_blocks.py --threads 64,128,512 --log 15,20

The kernel's block size is a compile-time constant, ZT_POSEIDON_THREADS
in csrc/field_kernels.cu (128 by default). This builds field_kernels.cu
once for each size given (one nvcc each, all started together, with the
port's flags, into build/poseidon_blocks/), then times the two-column BN254
8/56 sponge (the hashes path's call) of each build by CUDA events at each
2^log states, after holding its output to the default build's (the
wrapper ``field_kernels.poseidon_sponge``). Prints the card's name and
power limit, each build's ptxas line for the kernel, and one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import cuda_ms, rand_words  # noqa: E402


def build(threads) -> dict:
    """{threads: (library path, ptxas lines of poseidon_kernel)}."""
    from zelana_tpu_torch.ops import cuda

    out_dir = os.path.join(ROOT, "build", "poseidon_blocks")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(cuda.CSRC, "field_kernels.cu")
    procs = {}
    for th in threads:
        lib = os.path.join(out_dir, f"libfield_kernels_{th}.so")
        cmd = [cuda._nvcc(), *cuda.NVCC_FLAGS,
               f"-DZT_POSEIDON_THREADS={th}", "-o", lib, src]
        procs[th] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True),
                     lib)
    libs = {}
    for th, (proc, lib) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc, {th} threads:\n{text}")
        ptxas, inside = [], False
        for ln in text.splitlines():
            if "Compiling" in ln:
                inside = "poseidon_kernel" in ln
            elif inside and ("stack frame" in ln or "Used" in ln):
                ptxas.append(ln.replace("ptxas info    :", "").strip())
        libs[th] = (lib, ptxas)
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--threads", default="32,64,128,256,512")
    ap.add_argument("--log", default="15,20", help="log2 of the batches")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import numpy as np
    import torch

    from zelana_tpu_torch.hashes import poseidon as P
    from zelana_tpu_torch.hashes import poseidon_batch as PB
    from zelana_tpu_torch.ops import cuda
    from zelana_tpu_torch.ops import field_kernels as FK
    from zelana_tpu_torch.ops import limbs as L

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    threads = [int(t) for t in args.threads.split(",")]
    t0 = time.time()
    libs = build(threads)
    print(f"built {len(libs)} libraries in {time.time() - t0:.1f} s")
    for th, (_, ptxas) in libs.items():
        print(f"  {th} threads: {' | '.join(ptxas)}")

    dev = torch.device("cuda")
    cfg = P.bn254_config()
    spec = L.FieldSpec(cfg.modulus)
    consts = PB._device_tables(cfg, dev)
    rng = np.random.default_rng(15)
    result = {"card": card, "config": "BN254 8/56, two columns",
              "ms": {}, "registers": {}}
    cdlls = {}
    for th, (path, ptxas) in libs.items():
        regs = re.findall(r"Used (\d+) registers", " ".join(ptxas))
        result["registers"][str(th)] = [int(r) for r in regs]
        cdlls[th] = ctypes.CDLL(path)
        cuda._declare(cdlls[th])
    for lg in (int(x) for x in args.log.split(",")):
        n = 1 << lg
        cols = [rand_words(torch, rng, spec.modulus >> 224, n, dev)
                for _ in range(2)]
        want = FK.poseidon_sponge(cols, consts, cfg.full_rounds,
                                  cfg.partial_rounds, spec)
        ptrs = (ctypes.c_void_p * 2)(*[c.data_ptr() for c in cols])
        row = {}
        for th, cdll in cdlls.items():
            out = torch.empty_like(want)

            def call(cdll=cdll, out=out):
                rc = cdll.zt_poseidon(
                    FK._field_id(spec), ptrs, 2, None, out.data_ptr(), n,
                    consts.data_ptr(), cfg.full_rounds // 2,
                    cfg.partial_rounds,
                    torch.cuda.current_stream(dev).cuda_stream)
                if rc:
                    raise RuntimeError(f"zt_poseidon: CUDA error {rc}")

            call()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise AssertionError(f"{th} threads: output differs from "
                                     f"the default build's at 2^{lg}")
            row[str(th)] = cuda_ms(torch, call, args.reps)
        result["ms"][f"2^{lg}"] = row
        print(f"  2^{lg} states, ms by CUDA events a hash: {row}",
              flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
