"""Swarm cluster controller (prover-control parity, processes not docker).

The reference's prover-control (forge/crates/prover-control/src/main.rs)
drives a docker-compose cluster: start/stop/status/logs for the
coordinator + worker + node fleet. Here the controller manages local
SUBPROCESSES running the same services through the port's CLI
(`python -m zelana_tpu_torch.cli --device <device>
worker|node|coordinator`), which is also how the multi-host story maps:
one controller per host, services addressed by URL, the coordinator's
Dispatcher fanning chunks across them (runtime/worker.http_chunk_prover).
`device` is the services' `--device`: "cuda" by default, so a worker
keygens and proves on the card; on a host of several cards each worker
takes one (`device="cuda:k"`) and the network's key file (`pk=`)."""

from __future__ import annotations

import os
import re
import signal
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass
from typing import Dict, List, Optional


@dataclass
class Service:
    name: str
    kind: str  # "worker" | "node" | "coordinator"
    process: subprocess.Popen
    url: Optional[str] = None
    log_path: str = ""


class SwarmController:
    """start/stop/status/logs over a local service fleet. `log_dir`: where
    each service's output goes (a new temporary directory by default).
    `device`: the services' `--device` unless a start names one. A service
    stops when `stop` kills its process group; a worker or a coordinator
    also exits by itself when the process that started it does (it polls
    its parent)."""

    def __init__(self, log_dir: Optional[str] = None, device: str = "cuda"):
        self.log_dir = log_dir or tempfile.mkdtemp(prefix="zelana_swarm_")
        os.makedirs(self.log_dir, exist_ok=True)
        self.device = device
        self.services: Dict[str, Service] = {}

    def _launch(self, name: str, kind: str, args: List[str],
                device: Optional[str] = None) -> Service:
        """Start the process; the service is listed at once, so `stop`
        reaches it before it serves."""
        log_path = os.path.join(self.log_dir, f"{name}.log")
        with open(log_path, "w") as log:
            proc = subprocess.Popen(
                [sys.executable, "-m", "zelana_tpu_torch.cli",
                 "--device", device or self.device, kind, *args],
                stdout=log, stderr=subprocess.STDOUT,
                cwd=os.path.join(os.path.dirname(__file__), "..", ".."),
                env=dict(os.environ, PYTHONUNBUFFERED="1"),
                start_new_session=True,  # own process group: exact-kill target
            )
        svc = Service(name=name, kind=kind, process=proc, log_path=log_path)
        self.services[name] = svc
        return svc

    def _wait_url(self, svc: Service, url_pattern: str,
                  deadline: float) -> Service:
        """Wait for the service's URL in its log; on its exit or past the
        deadline, kill it, unlist it and raise."""
        while time.time() < deadline:
            if svc.process.poll() is not None:
                self.stop(svc.name)
                raise RuntimeError(f"{svc.name} exited with code "
                                   f"{svc.process.returncode}: "
                                   f"{self._tail(svc)}")
            m = re.search(url_pattern, self._tail(svc, None))
            if m:
                svc.url = m.group(1)
                return svc
            time.sleep(0.05)
        self.stop(svc.name)
        raise RuntimeError(f"{svc.name} did not come up in time: "
                           f"{self._tail(svc)}")

    @staticmethod
    def _tail(svc: Service, size: Optional[int] = 500) -> str:
        with open(svc.log_path) as f:
            text = f.read()
        return text if size is None else text[-size:]

    def _spawn(self, name: str, kind: str, args: List[str],
               url_pattern: str, timeout: float = 120.0) -> Service:
        svc = self._launch(name, kind, args)
        return self._wait_url(svc, url_pattern, time.time() + timeout)

    def start_node(self, node_id: int) -> Service:
        return self._spawn(
            f"node{node_id}", "node",
            ["--node-id", str(node_id), "--port", "0"],
            r"prover node \d+: (http://[\d.:]+)",
        )

    def start_worker(self, name: str, capacity: str = "1/1/1",
                     depth: int = 2, timeout: float = 900.0,
                     device: Optional[str] = None,
                     pk: Optional[str] = None) -> Service:
        """A chunk worker on `device`. With `pk`, a key file
        (ProvingKey.save_npz), it proves with that key; without one it
        keygens the chunk circuit on its device first (minutes on the CPU
        at real capacities; the default here is the tiny test shape)."""
        return self.start_workers([(name, device)], capacity, depth,
                                  timeout, pk)[0]

    def start_workers(self, workers, capacity: str = "1/1/1",
                      depth: int = 2, timeout: float = 900.0,
                      pk: Optional[str] = None) -> List[Service]:
        """Start chunk workers at once, one a (name, device) of `workers`,
        and wait until each serves. If one exits or does not come up, every
        one of them is stopped and this raises."""
        args = ["--capacity", capacity, "--depth", str(depth), "--port", "0"]
        args += ["--pk", pk] if pk else []
        started = [self._launch(name, "worker", args, device)
                   for name, device in workers]
        deadline = time.time() + timeout
        try:
            return [self._wait_url(svc, r"chunk worker: (http://[\d.:]+)",
                                   deadline) for svc in started]
        except BaseException:
            for svc in started:
                if svc.name in self.services:
                    self.stop(svc.name)
            raise

    def start_coordinator(self, workers: List[str], capacity: str = "1/1/1",
                          depth: int = 2) -> Service:
        """The prover coordinator alone, in a process of its own as forge's
        prover-coordinator runs, fanning each job's chunks over the chunk
        workers at the URLs `workers`."""
        return self._spawn(
            "coordinator", "coordinator",
            ["--workers", ",".join(workers), "--capacity", capacity,
             "--depth", str(depth), "--port", "0"],
            r"coordinator over \d+ workers: (http://[\d.:]+)")

    def status(self) -> Dict[str, dict]:
        out = {}
        for name, svc in self.services.items():
            rc = svc.process.poll()
            out[name] = {
                "kind": svc.kind,
                "url": svc.url,
                "running": rc is None,
                "returncode": rc,
            }
        return out

    def logs(self, name: str, tail: int = 50) -> str:
        lines = self._tail(self.services[name], None).splitlines()
        return "\n".join(lines[-tail:])

    def _kill(self, svc: Service):
        if svc.process.poll() is None:
            # exact process group started above; never a pattern kill
            os.killpg(svc.process.pid, signal.SIGTERM)
            try:
                svc.process.wait(timeout=5)
            except subprocess.TimeoutExpired:
                os.killpg(svc.process.pid, signal.SIGKILL)
                svc.process.wait()

    def stop(self, name: Optional[str] = None):
        targets = ([self.services[name]] if name
                   else list(self.services.values()))
        for svc in targets:
            self._kill(svc)
        if name:
            del self.services[name]
        else:
            self.services.clear()
