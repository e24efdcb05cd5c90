"""Interactive store inspector TUI (the reference's debug/db ratatui app).

    python -m zelana_tpu_torch.tools.db_tui <db_path>

Curses UI over the sqlite column-family store: one tab per column family
(accounts / transactions / nullifiers / batches / ... -- the reference's
views, debug/db/src/main.rs), scrollable row list with friendly decoding,
a detail pane for the selected row, and substring filtering.

Keys: Tab / Shift-Tab or Left/Right  switch column family
      Up/Down / PgUp/PgDn / g / G    move selection
      /                              filter (Enter applies, Esc clears)
      r                              reload from disk
      q                              quit

The decoding layer (decode_row / row_lines) is pure and unit-tested
without a terminal (tests/test_torch_tools.py); the curses loop is a thin
shell.
"""

from __future__ import annotations

import json
import sys
from typing import List, Tuple

from ..sequencer.store import COLUMN_FAMILIES, Store


# ---------------------------------------------------------------------------
# pure decoding layer
# ---------------------------------------------------------------------------


def decode_row(cf: str, key: bytes, value: bytes) -> Tuple[str, str]:
    """(summary, detail) for one row, human-first."""
    k = key.hex()
    if cf == "accounts" and len(value) >= 16:
        balance = int.from_bytes(value[:8], "little")
        nonce = int.from_bytes(value[8:16], "little")
        return (f"{k[:16]}..  balance={balance} nonce={nonce}",
                f"account {k}\nbalance {balance}\nnonce   {nonce}")
    if cf in ("tx_index", "batches", "stats", "withdrawals"):
        try:
            obj = json.loads(value)
            head = {kk: obj[kk] for kk in list(obj)[:3]}
            return (f"{k[:16]}..  {json.dumps(head, default=str)[:60]}",
                    f"{cf} {k}\n" + json.dumps(obj, indent=1, default=str))
        except Exception:
            pass
    if cf == "encrypted_notes" and len(value) >= 32:
        pos = int.from_bytes(key, "little") if len(key) == 8 else None
        return (f"pos={pos}  cm={value[:32].hex()[:24]}.. "
                f"({len(value) - 32}B ciphertext)",
                f"note position {pos}\ncommitment {value[:32].hex()}\n"
                f"ciphertext {value[32:].hex()}")
    if cf in ("nullifiers", "commitments", "processed_deposits"):
        return (k, f"{cf} {k}\nvalue {value.hex()}")
    if cf == "indexer_meta" or cf == "tree_meta":
        try:
            return (f"{key.decode()}: {value.hex()[:40]}",
                    f"{key.decode()}\n{value.hex()}")
        except UnicodeDecodeError:
            pass
    return (f"{k[:20]}..  {value.hex()[:40]}",
            f"key   {k}\nvalue {value.hex()}")


def row_lines(store: Store, cf: str, filter_text: str = "",
              limit: int = 2000) -> List[Tuple[str, str]]:
    """Decoded (summary, detail) rows of a column family, filtered."""
    out = []
    for key, value in store.scan(cf):
        summary, detail = decode_row(cf, key, value)
        if filter_text and filter_text.lower() not in summary.lower() \
                and filter_text.lower() not in detail.lower():
            continue
        out.append((summary, detail))
        if len(out) >= limit:
            break
    return out


def tab_counts(store: Store) -> List[Tuple[str, int]]:
    return [(cf, store.count(cf)) for cf in COLUMN_FAMILIES]


# ---------------------------------------------------------------------------
# curses shell
# ---------------------------------------------------------------------------


def _run(stdscr, store: Store):
    import curses

    curses.curs_set(0)
    tab = 0
    sel = 0
    top = 0
    filt = ""
    rows = row_lines(store, COLUMN_FAMILIES[tab], filt)

    def reload():
        nonlocal rows, sel, top
        rows = row_lines(store, COLUMN_FAMILIES[tab], filt)
        sel = min(sel, max(0, len(rows) - 1))
        top = min(top, sel)

    while True:
        stdscr.erase()
        h, w = stdscr.getmaxyx()
        counts = tab_counts(store)
        # tab bar
        x = 0
        for i, (cf, n) in enumerate(counts):
            label = f" {cf}({n}) "
            attr = curses.A_REVERSE if i == tab else curses.A_NORMAL
            if x + len(label) < w:
                stdscr.addstr(0, x, label[: w - x - 1], attr)
            x += len(label)
        status = f" filter: {filt or '-'}  [q quit  / filter  r reload]"
        stdscr.addstr(1, 0, status[: w - 1], curses.A_DIM)

        list_h = max(1, (h - 3) * 2 // 3)
        if sel < top:
            top = sel
        if sel >= top + list_h:
            top = sel - list_h + 1
        for i in range(list_h):
            idx = top + i
            if idx >= len(rows):
                break
            attr = curses.A_REVERSE if idx == sel else curses.A_NORMAL
            stdscr.addstr(2 + i, 0, rows[idx][0][: w - 1], attr)
        # detail pane
        dy = 2 + list_h + 1
        if rows and dy < h:
            stdscr.hline(dy - 1, 0, "-", w - 1)
            for j, line in enumerate(rows[sel][1].split("\n")):
                if dy + j >= h:
                    break
                stdscr.addstr(dy + j, 0, line[: w - 1])
        stdscr.refresh()

        ch = stdscr.getch()
        if ch in (ord("q"), 27):
            return
        elif ch in (9, curses.KEY_RIGHT):
            tab = (tab + 1) % len(COLUMN_FAMILIES)
            sel = top = 0
            reload()
        elif ch in (curses.KEY_BTAB, curses.KEY_LEFT):
            tab = (tab - 1) % len(COLUMN_FAMILIES)
            sel = top = 0
            reload()
        elif ch == curses.KEY_DOWN:
            sel = min(sel + 1, max(0, len(rows) - 1))
        elif ch == curses.KEY_UP:
            sel = max(sel - 1, 0)
        elif ch == curses.KEY_NPAGE:
            sel = min(sel + list_h, max(0, len(rows) - 1))
        elif ch == curses.KEY_PPAGE:
            sel = max(sel - list_h, 0)
        elif ch == ord("g"):
            sel = 0
        elif ch == ord("G"):
            sel = max(0, len(rows) - 1)
        elif ch == ord("r"):
            reload()
        elif ch == ord("/"):
            curses.echo()
            stdscr.addstr(1, 0, " " * (w - 1))
            stdscr.addstr(1, 0, "filter: ")
            try:
                filt = stdscr.getstr(1, 8, 60).decode()
            except Exception:
                filt = ""
            curses.noecho()
            sel = top = 0
            reload()


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print("usage: python -m zelana_tpu_torch.tools.db_tui <db_path>",
              file=sys.stderr)
        return 1
    store = Store(argv[0])
    import curses

    curses.wrapper(_run, store)
    return 0


if __name__ == "__main__":
    sys.exit(main())
