"""The result line and the refusals."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from portbench import harness as H
from portbench import run as R

from conftest import ROOT


def test_result_keys(small_chunk_cell):
    cell = small_chunk_cell
    out = R.run_cell(cell, 5, 0.2, False, device="cpu", t_start=time.time())
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"chunk_proofs_per_s", "setup_s"}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    json.dumps(out)
    # on the CPU the reference's stand-in calls none of the program's
    # spanned functions and no profiler runs: every reader finds nothing
    traced = R.run_cell(cell, 6, 0.2, True, device="cpu",
                        t_start=time.time())
    assert traced["correct"] and traced["metrics"] == {}


def test_no_card_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert R.main(["--workload", "chunk844_d32.backlog", "--seed", "1",
                   "--seconds", "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""


def test_bare_folder_fails(tmp_path):
    """Only BENCHMARK.json and the benchmark's files: no result."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(H.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "chunk844_d32.backlog", "--seed", "1", "--seconds", "1",
         "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_benchmark_json_shape():
    bench = H.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in names
            assert w in e2e[m["moves"]].get("workloads", names)
        assert os.path.exists(os.path.join(H.HERE, "metrics",
                                           m["name"] + ".py"))
    for c in bench["configs"]:
        cfg = H.load_json(os.path.join(ROOT, c["file"]))
        assert cfg["reduced"] == c["reduced"]
