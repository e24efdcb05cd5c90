"""Live DB/web explorer (debug/web parity, stdlib instead of Bun+Vite).

    python -m zelana_tpu_torch.tools.explorer <db_path> [--port N]

Serves a single-page explorer over a Store: column-family counts, account
balances, transaction index, batch records, nullifiers -- auto-refreshing
by polling the JSON endpoint (the reference pushes over WebSocket from a
Bun server, debug/web/server; polling is the zero-dependency equivalent of
its live view). Can also be mounted on a live PipelineOrchestrator's store
via `start_explorer(store, port)`.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..sequencer.store import COLUMN_FAMILIES, Store

_PAGE = """<!doctype html>
<html><head><title>zelana-tpu explorer</title><style>
body { font-family: ui-monospace, monospace; margin: 2em; background: #111;
       color: #ddd; }
h1 { font-size: 1.2em; } h2 { font-size: 1em; color: #8cf; }
table { border-collapse: collapse; margin-bottom: 1.5em; }
td, th { border: 1px solid #333; padding: 2px 8px; font-size: 0.85em; }
th { color: #8cf; text-align: left; }
.hex { color: #9a9; }
</style></head><body>
<h1>zelana-tpu store explorer</h1>
<div id="root">loading…</div>
<script>
async function refresh() {
  const r = await fetch('/data');
  const d = await r.json();
  let h = '<h2>column families</h2><table><tr><th>cf</th><th>rows</th></tr>';
  for (const [cf, n] of Object.entries(d.counts))
    h += `<tr><td>${cf}</td><td>${n}</td></tr>`;
  h += '</table><h2>accounts</h2><table><tr><th>pubkey</th><th>balance</th><th>nonce</th></tr>';
  for (const a of d.accounts)
    h += `<tr><td class=hex>${a.pk}</td><td>${a.balance}</td><td>${a.nonce}</td></tr>`;
  h += '</table><h2>batches</h2><table><tr><th>id</th><th>state</th><th>txs</th><th>signature</th></tr>';
  for (const b of d.batches)
    h += `<tr><td>${b.id}</td><td>${b.state}</td><td>${b.txs}</td><td class=hex>${(b.signature||'').slice(0,16)}</td></tr>`;
  h += '</table><h2>transactions</h2><table><tr><th>hash</th><th>kind</th><th>status</th><th>batch</th></tr>';
  for (const t of d.transactions)
    h += `<tr><td class=hex>${t.tx_hash.slice(0,16)}…</td><td>${t.kind}</td><td>${t.status}</td><td>${t.batch_id ?? ''}</td></tr>`;
  h += '</table><h2>nullifiers</h2><table><tr><th>nullifier</th></tr>';
  for (const n of d.nullifiers)
    h += `<tr><td class=hex>${n}</td></tr>`;
  h += '</table>';
  document.getElementById('root').innerHTML = h;
}
refresh(); setInterval(refresh, 2000);
</script></body></html>"""


def snapshot(store: Store, limit: int = 100) -> dict:
    counts = {cf: store.count(cf) for cf in COLUMN_FAMILIES}
    accounts = []
    for k, v in store.scan("accounts"):
        if len(accounts) >= limit:
            break
        accounts.append({
            "pk": k.hex(),
            "balance": int.from_bytes(v[:8], "little"),
            "nonce": int.from_bytes(v[8:16], "little") if len(v) >= 16 else 0,
        })
    batches = []
    for _, v in store.scan("batches"):
        if len(batches) >= limit:
            break
        batches.append(json.loads(v))
    txs = []
    for k, v in store.scan("tx_index"):
        if len(txs) >= limit:
            break
        rec = json.loads(v)
        rec["tx_hash"] = k.hex()
        txs.append(rec)
    nullifiers = [k.hex() for i, (k, _) in enumerate(store.scan("nullifiers"))
                  if i < limit]
    return {
        "counts": counts,
        "accounts": accounts,
        "batches": batches,
        "transactions": txs,
        "nullifiers": nullifiers,
    }


def start_explorer(store: Store, port: int = 0):
    """Returns (server, port); serve_forever runs on a daemon thread."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def do_GET(self):
            if self.path == "/data":
                body = json.dumps(snapshot(store)).encode()
                ctype = "application/json"
            elif self.path in ("/", "/index.html"):
                body = _PAGE.encode()
                ctype = "text/html"
            else:
                self.send_response(404)
                self.end_headers()
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, server.server_address[1]


def main(argv=None):
    parser = argparse.ArgumentParser(prog="explorer")
    parser.add_argument("db_path")
    parser.add_argument("--port", type=int, default=8899)
    args = parser.parse_args(argv)
    _, port = start_explorer(Store(args.db_path), args.port)
    print(f"explorer on http://127.0.0.1:{port}")
    threading.Event().wait()


if __name__ == "__main__":
    sys.exit(main())
