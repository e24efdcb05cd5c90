"""The benchmark of zelana_tpu_torch, one cell a run.

    python portbench/run.py --workload chunk844_d32.backlog --seed 7 \\
        --seconds 51 --trace 0

from the root of a checkout on a machine with the CUDA cards the cell asks
for. The cell (BENCHMARK.json `workloads`) names a configuration and a
traffic mix, found by name under portbench/configs and portbench/traffic.
Set-up (the key, the inputs from --seed, one warm-up prove at the cell's
shapes) is timed as setup_s; then units of work start while --seconds have
not passed and the window ends with the unit in flight. The outputs are
then held to the plain reference in portbench/reference/. The last line of
standard output is one JSON object: correct, attempted, failed, the
metrics (--trace 0: the cell's end-to-end metrics; --trace 1: its
per-layer metrics, read under torch.profiler and the benchmark's own spans),
device, with --trace 1 a breakdown, and the numbers compared beside their
limits ("checks", last). With no card, or fewer than the cell asks for, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import os
import sys
import time


def process_start() -> float:
    """The process's start on the time.time() clock (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


T_START = process_start()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# every compile cache of the run at a fixed path inside the checkout
os.environ.setdefault("TRITON_CACHE_DIR",
                      os.path.join(ROOT, "build", "portbench", "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      os.path.join(ROOT, "build", "portbench",
                                   "torch_extensions"))

import argparse  # noqa: E402
import json  # noqa: E402

from portbench import harness as H  # noqa: E402


class Context:
    """What a driver's setup gets: the cell, the seed, the device."""

    def __init__(self, cell, seed, seconds, device):
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.config, self.traffic = cell.config, cell.traffic
        self.device = device


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def run_cell(cell: H.Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float = None,
             base: str = H.HERE) -> dict:
    """One run of `cell`; returns the result line's object. device "cpu"
    runs the program's plain versions (the CPU tests); a measured run
    asks for "cuda". `base`: the folder the drivers and metrics are found
    in."""
    import torch

    from zelana_tpu_torch.ops import cuda

    t_start = T_START if t_start is None else t_start
    on_card = device == "cuda"
    driver = H.load_module("drivers", cell.traffic["driver"], base)
    session = driver.setup(Context(cell, seed, seconds, device))
    metrics = [(m, H.load_module("metrics", m["name"], base))
               for m in cell.per_layer] if trace else []
    hooks = profiler = None
    if trace:
        hooks = H.Hooks()
        hooks.install(h for _m, mod in metrics for h in mod.HOOKS)
        if on_card:
            profiler = H.Profiler(torch, cuda)
            with profiler.window():  # the profiler's first start is slow
                torch.zeros(1, device="cuda")
            profiler.windows.clear()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.time() - t_start
    log(f"set-up {setup_s:.3f} s; window of {seconds} s")
    try:
        run = H.run_window(session, seconds, profiler, hooks,
                           cell.traffic.get("units_per_profile", 1))
    finally:
        if hooks is not None:
            hooks.remove()
    wall = run.window[1] - run.window[0]
    if on_card:
        run.peak_bytes = torch.cuda.max_memory_allocated()
    log(f"window {wall:.3f} s: {len(run.units)} units, {run.proofs} proofs")

    out = {}
    if trace:
        for m, mod in metrics:
            value = mod.read(run)
            if value is not None:
                out[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        rates = {session.rate_metric: run.proofs / wall, "setup_s": setup_s}
        for m in cell.end_to_end:
            out[m["name"]] = {"value": rates[m["name"]], "unit": m["unit"]}
    outputs = [o for _s, _e, outs in run.units for o in outs]
    t0 = time.time()
    session.free()
    verdict = session.check(outputs)
    log(f"reference comparison {time.time() - t0:.3f} s "
        f"({verdict.rederived} outputs re-derived whole)")
    found = H.jax_modules()
    if found:
        raise SystemExit(f"JAX or the JAX package is loaded: {found}")
    device_info = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
        "count": cell.chips if on_card else 0,
        "memory_peak_bytes": run.peak_bytes}
    if trace and run.windows:
        device_info["busy_s"] = sum(w["busy_s"] for w in run.windows)
        device_info["window_s"] = sum(w["end"] - w["start"]
                                      for w in run.windows)
    result = {"correct": verdict.correct, "attempted": verdict.attempted,
              "failed": verdict.failed, "metrics": out, "device": device_info}
    if trace and run.windows:
        result["breakdown"] = H.breakdown(run.windows, run.hooks)
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, v, lim in verdict.numbers}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = H.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = H.find_cell(bench, args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"no result: the cell needs {cell.chips} CUDA card(s), this "
            f"machine has {torch.cuda.device_count()}")
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
