"""The port's store tools (zelana_tpu_torch.tools.db_tui, inspect_db) against
the JAX package's on one sqlite store written through the JAX
sequencer/store.py: decode_row, row_lines and tab_counts equal, and
inspect_db.main's output and exit code equal, with exact equality."""

import contextlib
import io
import json
import os
import subprocess
import sys

import pytest
import torch

from zelana_tpu.sequencer.store import Store as JStore
from zelana_tpu.tools import db_tui as JD
from zelana_tpu.tools import inspect_db as JI
from zelana_tpu_torch.sequencer.store import COLUMN_FAMILIES, Store
from zelana_tpu_torch.tools import db_tui as TD
from zelana_tpu_torch.tools import inspect_db as TI

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def db_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("db") / "store.sqlite")
    s = JStore(path)
    for i in range(3):
        s.put("accounts", bytes([0xA0 + i]) * 32,
              (500 + i).to_bytes(8, "little") + i.to_bytes(8, "little"))
    s.put("accounts", b"\x01" * 32, b"\x05")  # shorter than a balance
    s.put("tx_index", b"\x01" * 32, json.dumps(
        {"kind": "transfer", "status": "finalized", "batch_id": 7,
         "amount": 250}).encode())
    s.put("tx_index", b"\x02" * 32, b"not json")
    s.put("batches", (7).to_bytes(8, "little"), json.dumps(
        {"id": 7, "state": "finalized", "txs": 2}).encode())
    s.put("nullifiers", b"\x7b" * 32, b"\x01")
    s.put("encrypted_notes", (4).to_bytes(8, "little"),
          b"\x02" * 32 + b"\xcc" * 100)
    s.put("encrypted_notes", b"\x04" * 5, b"\x03" * 40)
    s.put("tree_meta", b"next_index", (9).to_bytes(8, "little"))
    s.put("tree_meta", b"\xff\xfe", b"\x00")  # a key that is not UTF-8
    s.close()
    return path


def test_decode_and_rows_equal_jax(db_path):
    js, ts = JStore(db_path), Store(db_path)
    assert TD.tab_counts(ts) == JD.tab_counts(js)
    for cf in COLUMN_FAMILIES:
        for key, value in ts.scan(cf):
            assert TD.decode_row(cf, key, value) == \
                JD.decode_row(cf, key, value)
        for filt in ("", "finalized", "BALANCE=501", "nonexistent-xyz"):
            assert TD.row_lines(ts, cf, filt) == JD.row_lines(js, cf, filt)
    assert TD.row_lines(ts, "accounts", limit=2) == \
        JD.row_lines(js, "accounts", limit=2)


@pytest.mark.parametrize("argv", [[], ["accounts"], ["accounts", "--limit",
                                                     "2"], ["tx_index"],
                                  ["encrypted_notes"], ["no_such_cf"]])
def test_inspect_db_equal_jax(db_path, argv):
    def run(main):
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = main([db_path] + argv)
        return rc, out.getvalue(), err.getvalue()

    got = run(TI.main)
    assert got == run(JI.main)
    assert got[0] == (1 if argv == ["no_such_cf"] else 0)


def test_inspect_db_module_runs(db_path):
    """python -m zelana_tpu_torch.tools.inspect_db prints what main does."""
    out = subprocess.run([sys.executable, "-m",
                          "zelana_tpu_torch.tools.inspect_db", db_path],
                         capture_output=True, text=True, timeout=120,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        JI.main([db_path])
    assert out.stdout == buf.getvalue()
