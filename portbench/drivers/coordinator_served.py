"""The prover network on one host: the coordinator alone, in a process of
its own (runtime/control.SwarmController.start_coordinator: `python -m
zelana_tpu_torch.cli coordinator --workers <urls>`, the /v2/batch routes
over a Dispatcher over runtime/worker.http_chunk_prover), fans each job's
chunks over chunk workers, one a card. Worker 0 is served from this process
(runtime/worker.start_worker over the prover `cli worker --pk` makes), so
that the run's profiler and its peak memory see a card's kernels; worker
k > 0 is a process (`python -m zelana_tpu_torch.cli worker --device cuda:k
--pk <key file>`). The key is made once from --seed on worker 0's device
and handed to every worker as a file (ProvingKey.save_npz).

Traffic parameters (traffic/<name>.json): "chunks" a job (the last one half
filled, frozen.production_spec with the backlog's draws, every shielded slot
a commitment), "jobs" a unit, "draw". A unit posts its jobs at once, each a
coordinator-shaped request (accounts, transfers, withdrawals, shielded
commitments, pre_shielded_root, batch_id) with a fresh batch id, and ends
when every job's proofs are fetched. The check is chunk_backlog's: every
proof's public inputs, and one proof of every chunk index re-derived whole;
the chunks of a job that failed count as missing. Configuration:
"capacity", "tree_depth", "workers".

The session keeps what its readers need (portbench/fleet.py): the
coordinator's `GET /spans` and each worker's.
"""

from __future__ import annotations

import atexit
import concurrent.futures as cf
import json
import os
import random
import shutil
import sys
import tempfile
import time
from urllib import request as urlrequest

from portbench import frozen
from portbench.control import ChunkProof
from portbench.drivers.chunk_backlog import Session as Backlog
from portbench.reference.chunk_batch import SMT

RATE_METRIC = "chunk_proofs_per_s"
JOB_SECONDS = 900  # a job not done by then counts as failed
POLL_S = 0.02


def served_spec(cap, chunks: int, rng: random.Random, draw: dict,
                depth: int) -> dict:
    """The backlog's batch with every shielded slot a commitment, as the
    coordinator request carries them: the first slot's spend becomes a
    commitment drawn next, and the note goes."""
    spec = frozen.production_spec(cap, chunks, rng, draw, depth)
    spec["notes"] = []
    spec["shielded"] = [rng.getrandbits(250)] + spec["shielded"][1:]
    return spec


def request_body(spec: dict, batch_id: int, pre_shielded_root: int) -> dict:
    """The coordinator-shaped request (CoreBatchProveRequest) of a spec,
    numbers as decimal strings."""
    def texts(rows):
        return [[str(x) for x in row] for row in rows]

    return {"batch_id": batch_id,
            "accounts": [{"pk": str(pk), "balance": str(b), "nonce": 0}
                         for pk, b in spec["funds"]],
            "transfers": texts(spec["transfers"]),
            "withdrawals": texts(spec["withdrawals"]),
            "shielded_commitments": [str(c) for c in spec["shielded"]],
            "pre_shielded_root": str(pre_shielded_root)}


def worker_devices(device: str, n: int) -> list:
    """Worker k's device: card k (run.py asks for the cell's cards; with
    fewer, as in a rehearsal on one card, k modulo their count), or the
    CPU for every worker."""
    if device == "cpu":
        return ["cpu"] * n
    import torch

    return [f"cuda:{k % torch.cuda.device_count()}" for k in range(n)]


def make_key(cap, depth: int, seed: int, device: str, folder: str) -> str:
    """The chunk circuit's key from `seed`, made on `device` and written to
    a file in `folder`; its path."""
    import torch

    from zelana_tpu_torch.runtime.chunk_prover import Groth16ChunkProver

    path = os.path.join(folder, "chunk_pk.npz")
    Groth16ChunkProver.setup(cap, depth, seed=seed,
                             device=device).pk.save_npz(path)
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return path


def local_prover(cap, depth: int, device: str, key: str):
    """A chunk worker's prover with the key file, as `cli worker --pk`
    makes it."""
    from zelana_tpu_torch.groth16.keys import ProvingKey
    from zelana_tpu_torch.runtime.chunk_prover import Groth16ChunkProver

    return Groth16ChunkProver(ProvingKey.load_npz(key), cap, depth,
                              device=device)


def start_fleet(cap, depth: int, devices: list, key: str, folder: str):
    """Worker 0 served from this process, one chunk worker process for
    each further device, and the coordinator's process over them all:
    (controller, worker 0's server, the workers' URLs, the coordinator's
    URL). If one fails to start, every one is stopped and this raises."""
    from zelana_tpu_torch.runtime.control import SwarmController
    from zelana_tpu_torch.runtime.worker import start_worker

    ctl = SwarmController(log_dir=os.path.join(folder, "logs"))
    server = None
    try:
        capacity = "/".join(map(str, cap))
        with cf.ThreadPoolExecutor(1) as ex:  # worker 0 loads meanwhile
            local = ex.submit(local_prover, cap, depth, devices[0], key)
            services = ctl.start_workers(
                [(f"worker{k}", d) for k, d in enumerate(devices) if k],
                capacity=capacity, depth=depth, timeout=600, pk=key)
            server, port = start_worker(local.result())
        urls = [f"http://127.0.0.1:{port}"] + [s.url for s in services]
        coordinator = ctl.start_coordinator(urls, capacity=capacity,
                                            depth=depth)
    except BaseException:
        ctl.stop()
        if server is not None:
            server.shutdown()
            server.server_close()
        raise
    return ctl, server, urls, coordinator.url


def http_json(url: str, body: dict = None, timeout: float = 600.0):
    data = None if body is None else json.dumps(body).encode()
    req = urlrequest.Request(url, data=data,
                             headers={"Content-Type": "application/json"})
    with urlrequest.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def most_at_once(rows) -> int:
    """The most of the records' [start, end] intervals open at one time."""
    ends = sorted([(r["start"], 1) for r in rows]
                  + [(r["end"], -1) for r in rows])
    now = most = 0
    for _t, step in ends:
        now += step
        most = max(most, now)
    return most


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


class Session(Backlog):
    rate_metric = RATE_METRIC

    def __init__(self, ctx):
        # a program without the coordinator's own process fails here, at once
        from zelana_tpu_torch.runtime.control import SwarmController

        if not hasattr(SwarmController, "start_coordinator"):
            raise SystemExit("the program has no coordinator service "
                             "(SwarmController.start_coordinator)")
        cfg, tr = ctx.config, ctx.traffic
        self.cap, self.depth = tuple(cfg["capacity"]), cfg["tree_depth"]
        self.seed, self.jobs = ctx.seed, tr["jobs"]
        rng = random.Random(ctx.seed)
        self.spec = served_spec(self.cap, tr["chunks"], rng, tr["draw"],
                                self.depth)
        # the chain's shielded root before the jobs: the empty note tree's
        self.pre_shielded = SMT(self.depth).root()
        self.next_id = rng.randrange(1, 1 << 40)
        self.batches = []  # batch ids the window attempted
        self.folder = tempfile.mkdtemp(prefix="portbench_served_")
        self.ctl = self.server = self.records = None
        atexit.register(self.free)
        try:
            devices = worker_devices(ctx.device, cfg["workers"])
            key = make_key(self.cap, self.depth, ctx.seed, devices[0],
                           self.folder)
            self.ctl, self.server, self.urls, self.url = start_fleet(
                self.cap, self.depth, devices, key, self.folder)
            # one job, so that every worker has proved once
            self.prove_jobs([self.fresh_id()])
        except BaseException:
            self.free()
            raise

    def fresh_id(self) -> int:
        self.next_id += 1
        return self.next_id - 1

    def run_unit(self) -> list:
        ids = [self.fresh_id() for _ in range(self.jobs)]
        self.batches += ids
        return self.prove_jobs(ids)

    def prove_jobs(self, ids) -> list:
        """Post one job a batch id at once, wait for all, fetch their
        proofs: (batch id, proof) each; a failed job gives none."""
        with cf.ThreadPoolExecutor(len(ids)) as ex:
            jobs = list(ex.map(lambda bid: http_json(
                self.url + "/v2/batch/prove",
                request_body(self.spec, bid, self.pre_shielded))["job_id"],
                ids))
        out = []
        for bid, job in zip(ids, jobs):
            result = self.wait(job)
            if result is None:
                log(f"job {bid}: failed")
                continue
            out += [(bid, ChunkProof(
                c["index"], bytes.fromhex(c["proof"]),
                [int(v) for v in c["public_inputs"]], c["proving_time_ms"],
                bytes.fromhex(c["public_witness"])))
                for c in result["chunks"]]
        log(f"jobs {ids}: chunk ms "
            f"{[cp.proving_time_ms for _b, cp in out]}")
        return out

    def wait(self, job: str):
        """The job's result once it is done; None if it failed or ran past
        JOB_SECONDS. Raises if a worker process has exited."""
        deadline = time.time() + JOB_SECONDS
        while time.time() < deadline:
            status = http_json(f"{self.url}/v2/batch/{job}/status")["status"]
            if status == "done":
                return http_json(f"{self.url}/v2/batch/{job}/proof")
            if status.startswith("failed"):
                log(f"job {job}: {status}")
                return None
            for name, s in self.ctl.status().items():
                if not s["running"]:
                    raise RuntimeError(f"{name} exited: "
                                       f"{self.ctl.logs(name, 20)}")
            time.sleep(POLL_S)
        return None

    def fleet_records(self) -> dict:
        """The coordinator's and each worker's `GET /spans`, fetched once,
        after the window."""
        if self.records is None:
            self.records = {
                "coordinator": http_json(self.url + "/spans")["spans"],
                "workers": [http_json(u + "/spans") for u in self.urls]}
        return self.records

    def free(self) -> None:
        """Stop the coordinator and the workers; logs each worker's device,
        peak device memory, chunk proofs and the most it held at once
        first."""
        if self.ctl is not None:
            try:
                for k, w in enumerate(self.fleet_records()["workers"]):
                    proves = [r for r in w["spans"]
                              if r["name"] == "chunk.prove"]
                    log(f"worker {k}: device {w['device']}, peak_bytes "
                        f"{w['peak_bytes']}, chunk proofs {len(proves)}, "
                        f"at most {most_at_once(proves)} at once")
            except OSError as exc:
                log(f"fleet records: {exc}")
            self.ctl.stop()
            self.ctl = None
        if self.server is not None:
            self.server.shutdown()
            self.server.server_close()
            self.server = None
        shutil.rmtree(self.folder, ignore_errors=True)
        import torch

        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def setup(ctx) -> Session:
    return Session(ctx)
