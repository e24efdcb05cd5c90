#!/usr/bin/env python3
"""How many of a window's kernels torch.profiler keeps, on one card.

    python3 tools/profile_windows.py            # from the repo root

In a fresh process, for `inv_fwd` (both thread mappings, forced through
field_kernels.inv_fwd_mapped) at 4,096, 2^16 and 2^20 Fr elements, profiles
`--windows` windows of 20 one-kernel calls each, and prints per
configuration the kernels each window kept, the device time a call they
give, and chip_smoke.spin_ms's time (CUDA events behind a spin kernel)
beside them, as one JSON line each. chip_smoke.py reads its device times
from such windows late in a long process, where they can come back short.
"""

import argparse
import functools
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as C  # noqa: E402


def window(torch, fn, reps: int):
    """(kernels kept, device ms a kept kernel) of one window of fn."""
    fn()
    torch.cuda.synchronize()
    with C.profiled(torch) as prof:
        for _ in range(reps):
            fn()
    events = C.device_events(prof, empty_ok=True)
    seen = sum(e.count for e in events)
    ms = sum(e.self_device_time_total for e in events) / 1e3
    return seen, ms / max(seen, 1)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--windows", type=int, default=6)
    args = ap.parse_args()
    import numpy as np
    import torch

    from zelana_tpu_torch.ops import field_kernels as FK
    from zelana_tpu_torch.ops import limbs as L

    if not torch.cuda.is_available():
        print("profile_windows: no CUDA device", file=sys.stderr)
        return 2
    dev, rng, reps = torch.device("cuda"), np.random.default_rng(0), 20
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(),
        flush=True)
    for n in (4096, 1 << 16, 1 << 20):
        a = C.rand_words(torch, rng, L.FR.modulus >> 224, n, dev)
        for scan in (False, True):
            fn = functools.partial(FK.inv_fwd_mapped, a, L.FR, scan)
            row = {"n": n, "scan": scan, "reps": reps}
            got = [window(torch, fn, reps) for _ in range(args.windows)]
            row["kept"] = [k for k, _ in got]
            row["device_ms"] = [round(t, 5) for _, t in got]
            row["spin_ms"] = [round(C.spin_ms(torch, fn, reps), 5)
                              for _ in range(3)]
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
