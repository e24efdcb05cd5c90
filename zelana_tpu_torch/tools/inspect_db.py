"""Store inspector (debug/db parity, CLI instead of TUI).

    python -m zelana_tpu_torch.tools.inspect_db <db_path> [cf] [--limit N]

Lists column families with row counts, or dumps a column family's rows
(hex keys/values, with friendly decoding for accounts).
"""

from __future__ import annotations

import argparse
import sys

from ..sequencer.store import COLUMN_FAMILIES, Store


def main(argv=None):
    parser = argparse.ArgumentParser(prog="inspect_db")
    parser.add_argument("db_path")
    parser.add_argument("cf", nargs="?", default=None)
    parser.add_argument("--limit", type=int, default=50)
    args = parser.parse_args(argv)

    store = Store(args.db_path)
    if args.cf is None:
        print(f"{'column family':24} rows")
        for cf in COLUMN_FAMILIES:
            print(f"{cf:24} {store.count(cf)}")
        return 0

    if args.cf not in COLUMN_FAMILIES:
        print(f"unknown column family: {args.cf}", file=sys.stderr)
        return 1

    for i, (k, v) in enumerate(store.scan(args.cf)):
        if i >= args.limit:
            print(f"... (limit {args.limit})")
            break
        if args.cf == "accounts" and len(v) >= 16:
            balance = int.from_bytes(v[:8], "little")
            nonce = int.from_bytes(v[8:16], "little")
            print(f"{k.hex()}  balance={balance} nonce={nonce}")
        else:
            print(f"{k.hex()}  {v.hex()[:96]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
