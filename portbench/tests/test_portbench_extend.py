"""A later PR adds a configuration, a cell and a per-layer metric with new
files and new entries only: the harness finds them by name, with no
existing file edited."""

import json
import os
import shutil
import time

from portbench import harness as H
from portbench import run as R

from conftest import ROOT


def test_new_cell_and_metric_from_files_only(tmp_path, monkeypatch):
    from portbench import control
    from zelana_tpu_torch.runtime import chunk_prover

    base = tmp_path / "portbench"
    shutil.copytree(H.HERE, base, ignore=shutil.ignore_patterns(
        "__pycache__"))
    before = {p: (base / p).read_bytes() for p in
              [os.path.relpath(os.path.join(d, f), base)
               for d, _s, fs in os.walk(base) for f in fs]}
    # the new files: a configuration, a traffic mix and a metric (a span
    # around the function that works out each of the stand-in's proofs)
    config = base / "configs" / "chunk202_d4.json"
    config.write_text(json.dumps({
        "name": "chunk202_d4", "capacity": [2, 0, 2], "tree_depth": 4,
        "reduced": []}))
    (base / "traffic" / "backlog_two.json").write_text(json.dumps({
        "driver": "chunk_backlog", "chunks": 2,
        "draw": {"fund": [50, 60], "transfer_amount": [1, 2],
                 "withdrawal_amount": [1, 2], "note_value": [1, 2]},
        "units_per_profile": 1}))
    (base / "metrics" / "ref_proof_ms.chunk.py").write_text(
        "from portbench.harness import span_ms\n\n"
        "HOOKS = [('portbench.reference.groth16', 'proof_points', 'span')]"
        "\n\n\ndef read(run):\n    return span_ms(run, 'proof_points')\n")
    bench = H.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    bench["configs"].append({"name": "chunk202_d4", "source": "a test",
                             "file": str(config), "reduced": [],
                             "why": "small"})
    bench["workloads"].append({"name": "chunk202_d4.backlog_two",
                               "config": "chunk202_d4",
                               "traffic": "backlog_two", "chips": 1,
                               "why": "two small chunks a batch"})
    bench["per_layer"].append({
        "name": "ref_proof_ms.chunk", "unit": "ms", "better": "lower",
        "source": "program_span", "layer": "groth16 prove",
        "moves": "chunk_proofs_per_s",
        "workloads": ["chunk202_d4.backlog_two"]})
    bench["end_to_end"][0]["workloads"].append("chunk202_d4.backlog_two")
    for f, data in before.items():
        assert (base / f).read_bytes() == data

    cell = H.find_cell(bench, "chunk202_d4.backlog_two", base=str(base))
    assert cell.traffic["chunks"] == 2 and cell.config["tree_depth"] == 4
    assert [m["name"] for m in cell.per_layer] == ["ref_proof_ms.chunk"]
    monkeypatch.setattr(chunk_prover, "Groth16ChunkProver",
                        control.ReferenceChunkProver)
    out = R.run_cell(cell, 31, 0.5, True, device="cpu",
                     t_start=time.time(), base=str(base))
    assert out["correct"]
    assert out["metrics"]["ref_proof_ms.chunk"]["value"] > 0
    out = R.run_cell(cell, 32, 0.5, False, device="cpu",
                     t_start=time.time(), base=str(base))
    assert out["correct"]
    assert set(out["metrics"]) == {"chunk_proofs_per_s", "setup_s"}
