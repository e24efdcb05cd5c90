"""The benchmark's machinery, driven by data: a cell of BENCHMARK.json
names a configuration (configs/<name>.json) and a traffic mix
(traffic/<name>.json); the traffic file names the driver
(drivers/<driver>.py) that makes its inputs and proves them; each
per-layer metric is a reader of its own (metrics/<name>.py). Nothing here
names a configuration, a traffic mix or a metric.

A driver module has `setup(ctx) -> session`. A session has `rate_metric`
(the end-to-end metric its window reports), `run_unit()` (one unit of
work: a batch or a proof; returns its outputs, one a proof), `free()`
(drops the program's state before the reference runs), `check(outputs)
-> Verdict`, and whatever its metrics read.

A metric module has `read(run) -> float | None` (None: nothing to read in
this run) and `HOOKS`: the program's functions it needs wrapped in a traced
run, as (module, attribute, "span" | "args"). A span records each call's
thread, start and end on the host clock; "args" keeps each call's first
argument. Hooks are set only in traced runs, from the benchmark's files.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import os
import statistics
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
JAX_NAMES = ("jax", "jaxlib", "flax", "zelana_tpu")


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str, base: str = HERE):
    """portbench/<kind>/<name>.py, found by name (names may hold dots)."""
    path = os.path.join(base, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_modules() -> list:
    """Modules whose top-level name is JAX's or the JAX package's, compared
    whole (zelana_tpu_torch is not zelana_tpu)."""
    return sorted(n for n in sys.modules if n.split(".")[0] in JAX_NAMES)


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list  # the end-to-end metric entries this cell reports
    per_layer: list  # the per-layer metric entries this cell reports


def find_cell(bench: dict, name: str, base: str = HERE) -> Cell:
    """The cell `name` of a BENCHMARK.json, its files loaded by name. A
    metric with a `workloads` key is the listed cells'; an end-to-end
    metric without one is every cell's, a per-layer metric without one is
    the cells' that report the end-to-end metric it moves."""
    for w in bench["workloads"]:
        if w["name"] == name:
            break
    else:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", (name,))]
    e2e_names = {m["name"] for m in e2e}
    config = next(c for c in bench["configs"] if c["name"] == w["config"])
    return Cell(
        name=name,
        config=load_json(os.path.join(ROOT, config["file"])),
        traffic=load_json(os.path.join(base, "traffic",
                                       w["traffic"] + ".json")),
        chips=w["chips"], end_to_end=e2e,
        per_layer=[m for m in bench["per_layer"]
                   if (name in m["workloads"] if "workloads" in m
                       else m["moves"] in e2e_names)])


@dataclasses.dataclass
class Verdict:
    """What the comparison with the reference found: each number compared
    with its limit (a number above its limit makes the run not correct)."""

    attempted: int
    failed: int
    numbers: list  # [(name, value, limit)]
    rederived: int = 0  # outputs the reference worked out whole

    @property
    def correct(self) -> bool:
        return all(v <= lim for _n, v, lim in self.numbers)


class Hooks:
    """The traced run's wrappers around the program's functions."""

    def __init__(self):
        self.spans: dict = {}  # name -> [(thread, start, end)]
        self.args: dict = {}  # name -> [(window, first argument)]
        self.window = -1
        self._undo = []
        self._lock = threading.Lock()

    def install(self, specs) -> None:
        for module, attr, kind in sorted(set(map(tuple, specs))):
            mod = importlib.import_module(module)
            real = getattr(mod, attr)
            wrapper = (self._span(attr, real) if kind == "span"
                       else self._keep(attr, real))
            setattr(mod, attr, wrapper)
            self._undo.append((mod, attr, real))

    def remove(self) -> None:
        for mod, attr, real in reversed(self._undo):
            setattr(mod, attr, real)
        self._undo.clear()

    def _span(self, name, real):
        out = self.spans.setdefault(name, [])

        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            try:
                return real(*a, **kw)
            finally:
                with self._lock:
                    out.append((threading.get_ident(), t0,
                                time.perf_counter()))
        return wrapped

    def _keep(self, name, real):
        out = self.args.setdefault(name, [])

        def wrapped(*a, **kw):
            with self._lock:
                out.append((self.window, a[0]))
            return real(*a, **kw)
        return wrapped


def union_s(intervals) -> float:
    """Seconds covered by the union of (start, end) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def gaps(intervals, lo: float, hi: float) -> list:
    """The idle (start, end) gaps of the union of intervals within
    [lo, hi]."""
    out, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if hi > cur:
        out.append((cur, hi))
    return out


class Profiler:
    """Profiler windows around units of work: torch.profiler over the host
    and the card. Keeps, per window, the device events as (name, start,
    end) on the host clock, the port's kernels seen, and the launches the
    port counted (ops/cuda.LAUNCHES)."""

    PORT_TAIL = ("bucket_merge_kernel", "bucket_tree_kernel")

    def __init__(self, torch, cuda):
        self.torch, self.cuda = torch, cuda
        self.windows: list = []

    @contextlib.contextmanager
    def window(self):
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile, record_function

        self.torch.cuda.synchronize()
        before = dict(self.cuda.LAUNCHES)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function("portbench.window"):
                t0 = time.perf_counter()
                yield
                self.torch.cuda.synchronize()
                t1 = time.perf_counter()
        launches = sum(v - before[k] for k, v in self.cuda.LAUNCHES.items())
        events = prof.events()
        mark = next(e for e in events if e.name == "portbench.window")
        offset = mark.time_range.start / 1e6 - t0  # trace s - host s
        # the device's kernels, copies and sets; a record_function range
        # shows on the device's timeline too (a user annotation) and is
        # no device work
        dev = [(e.name, e.time_range.start / 1e6 - offset,
                e.time_range.end / 1e6 - offset)
               for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and e.name != "portbench.window"]
        names = tuple(f"{k}_kernel" for k in self.cuda.LAUNCHES
                      if k != "bucket_tail") + self.PORT_TAIL
        kernels = sum(1 for n, _s, _e in dev if any(k in n for k in names))
        self.windows.append({"start": t0, "end": t1, "events": dev,
                             "kernels": kernels, "launches": launches,
                             "busy_s": union_s((s, e) for _n, s, e in dev)})


@dataclasses.dataclass
class Run:
    """What a run measured, for the metric readers."""

    session: object
    proofs: int
    units: list  # (start, end, outputs) a unit, host clock
    window: tuple  # (start, end)
    hooks: Hooks = None
    windows: list = dataclasses.field(default_factory=list)
    peak_bytes: int = 0


def run_window(session, seconds: float, profiler: Profiler = None,
               hooks: Hooks = None, every: int = 1) -> Run:
    """Start units of work while `seconds` have not passed; the window
    ends when the unit in flight ends, so no proof is dropped or
    half-counted and the window overruns by at most one unit. With a
    profiler, up to `every` units at a time make one profiler window."""
    units = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        if hooks is not None and profiler is not None:
            hooks.window = len(profiler.windows)
        with (profiler.window() if profiler is not None
              else contextlib.nullcontext()):
            for _ in range(every):
                s = time.perf_counter()
                out = session.run_unit()
                units.append((s, time.perf_counter(), out))
                if time.perf_counter() - t0 >= seconds:
                    break
    return Run(session=session, proofs=sum(len(u[2]) for u in units),
               units=units, window=(t0, time.perf_counter()), hooks=hooks,
               windows=profiler.windows if profiler is not None else [])


def quantile(values, q: float) -> float:
    """The q-quantile (0 < q < 1) by statistics.quantiles' inclusive
    method; a single value is its own quantile."""
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[
        round(q * 100) - 1]


def breakdown(windows: list, hooks: Hooks) -> dict:
    """The device operations that took most time, and the longest idle
    gaps named by the spans the host was in, over the profiled windows."""
    by_name: dict = {}
    idle = []
    spans = [(name, s, e) for name, rows in (hooks.spans.items() if hooks
                                              else ())
             for _t, s, e in rows]
    for w in windows:
        for n, s, e in w["events"]:
            by_name[n] = by_name.get(n, 0.0) + (e - s)
        for s, e in gaps([(s, e) for _n, s, e in w["events"]],
                         w["start"], w["end"]):
            mid = (s + e) / 2
            inside = sorted({n for n, a, b in spans if a <= mid <= b})
            idle.append(["+".join(inside) or "host outside the spans",
                         e - s])
    ops = sorted(([n[:120], v] for n, v in by_name.items()),
                 key=lambda x: -x[1])[:10]
    return {"device_ops": ops,
            "idle_gaps": sorted(idle, key=lambda x: -x[1])[:10]}


# ------------------------------------------------- for the metric readers --

def kept_windows(run: Run) -> list:
    """The profiler windows that hold every port kernel the port counted
    (frozen.choose_windows)."""
    from portbench.frozen import choose_windows

    return choose_windows(run.windows)


def proofs_in(run: Run, windows) -> int:
    """Proofs of the units that ran inside the given windows."""
    return sum(len(out) for s, e, out in run.units
               if any(w["start"] <= s and e <= w["end"] for w in windows))


def device_ms(windows, names) -> float:
    """Device time (ms) of the events whose name holds one of `names`."""
    return 1e3 * sum(e - s for w in windows for n, s, e in w["events"]
                     if any(k in n for k in names))


def idle_share(run: Run):
    """1 - the union of device activity over the windows' wall time, over
    the windows that kept all their kernels; None where none did."""
    kept = kept_windows(run)
    if not kept:
        return None
    wall = sum(w["end"] - w["start"] for w in kept)
    return 1 - sum(w["busy_s"] for w in kept) / wall


def span_ms(run: Run, name: str):
    """Mean duration (ms) of the window's calls of a spanned function."""
    rows = [(s, e) for _t, s, e in (run.hooks.spans.get(name, [])
                                    if run.hooks else [])
            if run.window[0] <= s and e <= run.window[1]]
    return 1e3 * statistics.fmean(e - s for s, e in rows) if rows else None
