"""The traffic generators: the same seed gives the same inputs, another
seed other values in the same shape, and the unseeded chunk batch is the
smoke script's production batch."""

import random

from portbench import frozen
from portbench.harness import ROOT, find_cell, load_json

DRAW = load_json(f"{ROOT}/portbench/traffic/backlog.json")["draw"]


def spec(seed, depth=32):
    return frozen.production_spec((8, 4, 4), 5, random.Random(seed), DRAW,
                                  depth)


def test_chunk_spec_deterministic_in_seed():
    big = 2**31 + 2**30 + 12345
    assert spec(big) == spec(big)
    a, b = spec(big), spec(big + 1)
    assert a != b
    for k in ("funds", "transfers", "withdrawals", "shielded"):
        assert len(a[k]) == len(b[k])
    assert [len(x) for x in (a["transfers"], a["withdrawals"],
                             a["shielded"])] == [36, 18, 18]
    assert a["shielded"][0][0] == "full"


def test_chunk_spec_positions_distinct():
    for depth in (4, 32):
        pos = [pk & ((1 << depth) - 1) for pk, _ in spec(7, depth)["funds"]]
        assert len(set(pos)) == 15 and 0 not in pos


def test_unseeded_spec_is_the_smoke_batch(monkeypatch):
    """chip_smoke.production_batch hands the coordinator these slots."""
    import chip_smoke
    from zelana_tpu_torch.runtime import coordinator

    seen = {}

    class Builder:
        def fund(self, pk, balance):
            seen.setdefault("funds", []).append((pk, balance))

        def add_note(self, spending_key, value, blinding):
            seen["notes"] = [(spending_key, value, blinding)]
            return 0

        def shielded_root(self):
            return 0

    def build(builder, transfers, withdrawals, shielded, capacity,
              pre_shielded_root):
        seen.update(transfers=transfers, withdrawals=withdrawals,
                    shielded=[list(s) if isinstance(s, tuple) else s
                              for s in shielded])
        return []

    monkeypatch.setattr(coordinator.Dispatcher, "build_chunks_with_witness",
                        staticmethod(build))
    chip_smoke.production_batch(Builder(), (8, 4, 4))
    assert frozen.production_spec((8, 4, 4)) == seen


def test_cells_find_their_files():
    bench = load_json(f"{ROOT}/BENCHMARK.json")
    for w in bench["workloads"]:
        cell = find_cell(bench, w["name"])
        assert cell.traffic["driver"]
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert cell.per_layer
