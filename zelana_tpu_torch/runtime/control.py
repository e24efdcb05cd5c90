"""Swarm cluster controller (prover-control parity, processes not docker).

The reference's prover-control (forge/crates/prover-control/src/main.rs)
drives a docker-compose cluster: start/stop/status/logs for the
coordinator + worker + node fleet. Here the controller manages local
SUBPROCESSES running the same services through the port's CLI
(`python -m zelana_tpu_torch.cli --device <device> worker|node`), which is
also how the multi-host story maps: one controller per host, services
addressed by URL, the coordinator's Dispatcher fanning chunks across them
(runtime/worker.http_chunk_prover). `device` is the services' `--device`:
"cuda" by default, so a worker keygens and proves on the card."""

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
    kind: str  # "worker" | "node"
    process: subprocess.Popen
    url: Optional[str] = None
    log_path: str = ""


class SwarmController:
    """start/stop/status/logs over a local service fleet. `log_dir`: where
    each service's output goes (a new temporary directory by default)."""

    def __init__(self, log_dir: Optional[str] = None, device: str = "cuda"):
        self.log_dir = log_dir or tempfile.mkdtemp(prefix="zelana_swarm_")
        os.makedirs(self.log_dir, exist_ok=True)
        self.device = device
        self.services: Dict[str, Service] = {}

    def _spawn(self, name: str, kind: str, args: List[str],
               url_pattern: str, timeout: float = 120.0) -> Service:
        log_path = os.path.join(self.log_dir, f"{name}.log")
        log = open(log_path, "w")
        proc = subprocess.Popen(
            [sys.executable, "-m", "zelana_tpu_torch.cli",
             "--device", self.device, kind, *args],
            stdout=log, stderr=subprocess.STDOUT,
            cwd=os.path.join(os.path.dirname(__file__), "..", ".."),
            start_new_session=True,  # own process group: exact-kill target
        )
        log.close()
        svc = Service(name=name, kind=kind, process=proc, log_path=log_path)
        deadline = time.time() + timeout
        while time.time() < deadline:
            if proc.poll() is not None:
                raise RuntimeError(
                    f"{name} exited: {open(log_path).read()[-500:]}")
            m = re.search(url_pattern, open(log_path).read())
            if m:
                svc.url = m.group(1)
                break
            time.sleep(0.05)
        if svc.url is None:
            self._kill(svc)
            raise RuntimeError(f"{name} did not come up in {timeout}s")
        self.services[name] = svc
        return svc

    def start_node(self, node_id: int) -> Service:
        return self._spawn(
            f"node{node_id}", "node",
            ["--node-id", str(node_id), "--port", "0"],
            r"prover node \d+: (http://[\d.:]+)",
        )

    def start_worker(self, name: str, capacity: str = "1/1/1",
                     depth: int = 2, timeout: float = 900.0) -> Service:
        """NOTE: worker startup keygens the chunk circuit on the device
        (minutes on the CPU at real capacities; the default here is the
        tiny test shape)."""
        return self._spawn(
            name, "worker",
            ["--capacity", capacity, "--depth", str(depth), "--port", "0"],
            r"chunk worker: (http://[\d.:]+)", timeout=timeout,
        )

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
        svc = self.services[name]
        lines = open(svc.log_path).read().splitlines()
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
