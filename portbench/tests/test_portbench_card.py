"""On the card: each cell's run prints a correct result. Run on a machine
with a card: `python -m pytest portbench/tests -q -m card`."""

import json
import subprocess
import sys

import pytest

from portbench.harness import ROOT, load_json


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in load_json(
    f"{ROOT}/BENCHMARK.json")["workloads"]])
def test_cell_on_card(card, cell):
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        cell, "--seed", "20261018", "--seconds", "5",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["kind"] == card
