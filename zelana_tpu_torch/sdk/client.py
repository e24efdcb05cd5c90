"""Zelana client SDK: HTTP client for the sequencer API.

Python mirror of the reference TypeScript SDK's two-layer client
(sdk/typescript/src/client.ts `ApiClient` — raw route bindings — and
sdk/typescript/src/zelana.ts `ZelanaClient` — keypair-aware convenience
layer with transfer/withdraw signing, nonce management, and
wait-for-transaction polling). Route shapes match
sequencer/api.py, which mirrors core/src/api/routes.rs:14-66.

Stdlib-only (urllib); no external HTTP dependency.
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request
from dataclasses import dataclass
from typing import List, Optional

from .keypair import ZelanaKeypair


class ApiError(RuntimeError):
    def __init__(self, status: int, message: str):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status
        self.message = message


@dataclass
class AccountState:
    balance: int
    nonce: int
    pending_balance: Optional[int] = None
    pending_nonce: Optional[int] = None


class ApiClient:
    """Raw route bindings (client.ts:51). One method per endpoint."""

    def __init__(self, base_url: str, timeout: float = 10.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    # -- transport ---------------------------------------------------------

    def _request(self, method: str, path: str, body: Optional[dict] = None):
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            self.base_url + path,
            data=data,
            method=method,
            headers={"Content-Type": "application/json"},
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return json.loads(resp.read())
        except urllib.error.HTTPError as exc:
            try:
                payload = json.loads(exc.read())
                msg = payload.get("error", str(payload))
            except Exception:
                msg = exc.reason
            raise ApiError(exc.code, msg) from None

    def get(self, path: str):
        return self._request("GET", path)

    def post(self, path: str, body: dict):
        return self._request("POST", path, body)

    # -- status ------------------------------------------------------------

    def health(self) -> dict:
        return self.get("/health")

    def get_state_roots(self) -> dict:
        return self.get("/status/roots")

    def get_batch_status(self) -> dict:
        return self.get("/status/batch")

    def get_stats(self) -> dict:
        return self.get("/status/stats")

    # -- accounts ------------------------------------------------------------

    def get_account(self, pubkey: bytes) -> AccountState:
        r = self.post("/account", {"account_id": pubkey.hex()})
        return AccountState(
            balance=int(r["balance"]),
            nonce=int(r["nonce"]),
            pending_balance=r.get("pending_balance"),
            pending_nonce=r.get("pending_nonce"),
        )

    # -- transactions --------------------------------------------------------

    def submit_transfer(self, from_: bytes, to: bytes, amount: int,
                        nonce: int, signature: bytes) -> dict:
        return self.post("/transfer", {
            "from": from_.hex(), "to": to.hex(), "amount": amount,
            "nonce": nonce, "signature": signature.hex(),
        })

    def submit_withdrawal(self, from_: bytes, to_l1_address: bytes,
                          amount: int, nonce: int, signature: bytes) -> dict:
        return self.post("/withdraw", {
            "from": from_.hex(), "to_l1_address": to_l1_address.hex(),
            "amount": amount, "nonce": nonce, "signature": signature.hex(),
        })

    def get_withdrawal_status(self, tx_hash: str) -> dict:
        return self.post("/withdraw/status", {"tx_hash": tx_hash})

    def get_fast_withdraw_quote(self, amount: int) -> dict:
        return self.post("/withdraw/fast/quote", {"amount": amount})

    def fast_withdraw(self, from_: bytes, to_l1_address: bytes, amount: int,
                      nonce: int, signature: bytes) -> dict:
        return self.post("/withdraw/fast/execute", {
            "from": from_.hex(), "to_l1_address": to_l1_address.hex(),
            "amount": amount, "nonce": nonce, "signature": signature.hex(),
        })

    # -- shielded ------------------------------------------------------------

    def submit_shielded(self, nullifier: bytes, commitment: bytes,
                        proof: bytes = b"", ciphertext: bytes = b"",
                        merkle_root: bytes = b"",
                        delegated: bool = False) -> dict:
        path = "/shielded/delegated" if delegated else "/shielded/submit"
        return self.post(path, {
            "nullifier": nullifier.hex(), "commitment": commitment.hex(),
            "proof": proof.hex(), "ciphertext": ciphertext.hex(),
            "merkle_root": merkle_root.hex(),
        })

    def get_merkle_path(self, position: int) -> dict:
        return self.post("/shielded/merkle_path", {"position": position})

    def scan_notes(self, from_position: int = 0, limit: int = 1000) -> dict:
        return self.post("/shielded/scan", {
            "from_position": from_position, "limit": limit,
        })

    def get_shielded_root(self) -> bytes:
        return bytes.fromhex(self.get("/shielded/root")["root"])

    # -- encrypted mempool -----------------------------------------------------

    def get_committee(self) -> dict:
        return self.get("/encrypted/committee")

    def submit_encrypted(self, tx_id: bytes, ciphertext: bytes,
                         encrypted_shares: dict) -> dict:
        return self.post("/encrypted/submit", {
            "tx_id": tx_id.hex(), "ciphertext": ciphertext.hex(),
            "encrypted_shares": {
                str(k): v.hex() for k, v in encrypted_shares.items()
            },
        })

    # -- batches / txs ---------------------------------------------------------

    def get_batch(self, batch_id: int) -> Optional[dict]:
        try:
            return self.post("/batch", {"batch_id": batch_id})
        except ApiError as exc:
            if exc.status == 404:
                return None
            raise

    def list_batches(self, limit: int = 100) -> List[dict]:
        return self.post("/batches", {"limit": limit})["batches"]

    def get_transaction(self, tx_hash: str) -> Optional[dict]:
        try:
            return self.post("/tx", {"tx_hash": tx_hash})
        except ApiError as exc:
            if exc.status == 404:
                return None
            raise

    def list_transactions(self, limit: int = 100) -> List[dict]:
        return self.post("/txs", {"limit": limit})["txs"]

    # -- dev mode ----------------------------------------------------------------

    def dev_deposit(self, to: bytes, amount: int, l1_seq: int = 0) -> dict:
        return self.post("/dev/deposit", {
            "to": to.hex(), "amount": amount, "l1_seq": l1_seq,
        })

    def dev_seal(self) -> dict:
        return self.post("/dev/seal", {})

    # -- prover-coordinator job API -----------------------------------------------
    # (NoirProverClient surface, core/src/sequencer/settlement/noir_client.rs)

    def prove_batch(self, request: Optional[dict] = None) -> str:
        """Start a prove job. Pass the coordinator-shaped request
        (accounts/transfers/withdrawals/shielded_commitments) to drive the
        chunked dispatcher; empty body proves the pipeline's sealed batch."""
        return self.post("/v2/batch/prove", request or {})["job_id"]

    def prove_status(self, job_id: str) -> str:
        return self.get(f"/v2/batch/{job_id}/status")["status"]

    def stream_status(self, job_id: str, timeout: float = 300.0):
        """SSE status stream (noir_client.rs:432-549's SSE leg): yields
        status strings until the job is terminal."""
        url = f"{self.base_url}/v2/batch/{job_id}/status?stream=1"
        req = urllib.request.Request(
            url, headers={"Accept": "text/event-stream"})
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            for raw in resp:
                line = raw.decode().strip()
                if line.startswith("data:"):
                    status = json.loads(line[5:].strip())["status"]
                    yield status
                    if status in ("done", "unknown") or status.startswith(
                            "failed"):
                        return

    def fetch_proof(self, job_id: str) -> dict:
        return self.get(f"/v2/batch/{job_id}/proof")

    def wait_for_proof(self, job_id: str, timeout: float = 300.0) -> dict:
        """Follow the SSE stream to completion, then fetch the proof."""
        for status in self.stream_status(job_id, timeout=timeout):
            if status == "done":
                return self.fetch_proof(job_id)
            if status.startswith("failed") or status == "unknown":
                raise ApiError(500, f"prove job {job_id}: {status}")
        raise ApiError(504, f"prove job {job_id} did not finish")

    @staticmethod
    def detect_proof_format(proof_bytes: bytes) -> str:
        """The settler's autodetect (settler.rs:543-546): 388/624 bytes ->
        noir/sunspot, 256 -> groth16."""
        if len(proof_bytes) in (388, 624):
            return "noir"
        if len(proof_bytes) == 256:
            return "groth16"
        return "unknown"


class ZelanaClient:
    """Keypair-aware convenience client (zelana.ts:63).

    Signs transfers/withdrawals with the wallet's Ed25519 key using the
    canonical signing message (sequencer/transactions.py), auto-fills
    nonces from the account state (pending nonce wins, matching the TS
    client's optimistic nonce tracking), and offers wait_for_* pollers.
    """

    def __init__(self, base_url: str,
                 keypair: Optional[ZelanaKeypair] = None,
                 timeout: float = 10.0):
        self.api = ApiClient(base_url, timeout=timeout)
        self.keypair = keypair

    # -- status ------------------------------------------------------------

    def is_healthy(self) -> bool:
        try:
            return self.api.health().get("status") == "ok"
        except Exception:
            return False

    def get_state_roots(self) -> dict:
        return self.api.get_state_roots()

    def get_batch_status(self) -> dict:
        return self.api.get_batch_status()

    def get_stats(self) -> dict:
        return self.api.get_stats()

    # -- account -----------------------------------------------------------

    @property
    def pubkey(self) -> bytes:
        if self.keypair is None:
            raise ValueError("client has no keypair")
        return self.keypair.pubkey

    def get_account(self) -> AccountState:
        return self.api.get_account(self.pubkey)

    def get_account_for(self, pubkey: bytes) -> AccountState:
        return self.api.get_account(pubkey)

    def get_balance(self) -> int:
        return self.get_account().balance

    def get_nonce(self) -> int:
        """Next usable nonce: the pending nonce if a tx is in flight."""
        acct = self.get_account()
        if acct.pending_nonce is not None:
            return acct.pending_nonce
        return acct.nonce

    # -- transfers -----------------------------------------------------------

    def transfer(self, to: bytes, amount: int,
                 nonce: Optional[int] = None) -> dict:
        from ..sequencer.transactions import Transfer

        if nonce is None:
            nonce = self.get_nonce()
        tx = Transfer(signer_pubkey=self.pubkey, to=to, amount=amount,
                      nonce=nonce)
        sig = self.keypair.sign_raw(tx.signing_message())
        return self.api.submit_transfer(self.pubkey, to, amount, nonce, sig)

    def transfer_all(self, to: bytes) -> dict:
        return self.transfer(to, self.get_balance())

    def withdraw(self, to_l1_address: bytes, amount: int,
                 nonce: Optional[int] = None) -> dict:
        from ..sequencer.transactions import Withdraw

        if nonce is None:
            nonce = self.get_nonce()
        tx = Withdraw(from_=self.pubkey, to_l1_address=to_l1_address,
                      amount=amount, nonce=nonce)
        sig = self.keypair.sign_raw(tx.signing_message())
        return self.api.submit_withdrawal(
            self.pubkey, to_l1_address, amount, nonce, sig
        )

    def fast_withdraw(self, to_l1_address: bytes, amount: int,
                      nonce: Optional[int] = None) -> dict:
        from ..sequencer.transactions import Withdraw

        if nonce is None:
            nonce = self.get_nonce()
        tx = Withdraw(from_=self.pubkey, to_l1_address=to_l1_address,
                      amount=amount, nonce=nonce)
        sig = self.keypair.sign_raw(tx.signing_message())
        return self.api.fast_withdraw(
            self.pubkey, to_l1_address, amount, nonce, sig
        )

    def get_withdrawal_status(self, tx_hash: str) -> dict:
        return self.api.get_withdrawal_status(tx_hash)

    def get_fast_withdraw_quote(self, amount: int) -> dict:
        return self.api.get_fast_withdraw_quote(amount)

    # -- queries ------------------------------------------------------------

    def get_transaction(self, tx_hash: str) -> Optional[dict]:
        return self.api.get_transaction(tx_hash)

    def list_transactions(self, limit: int = 100) -> List[dict]:
        return self.api.list_transactions(limit)

    def get_batch(self, batch_id: int) -> Optional[dict]:
        return self.api.get_batch(batch_id)

    def list_batches(self, limit: int = 100) -> List[dict]:
        return self.api.list_batches(limit)

    # -- pollers (zelana.ts:344 waitForTransaction / :382 waitForBatch) ------

    def wait_for_transaction(self, tx_hash: str, timeout: float = 30.0,
                             poll_interval: float = 0.05) -> dict:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            record = self.get_transaction(tx_hash)
            if record is not None:
                return record
            time.sleep(poll_interval)
        raise TimeoutError(f"transaction {tx_hash} not found in {timeout}s")

    def wait_for_batch(self, batch_id: int, states=("settled", "finalized"),
                       timeout: float = 30.0,
                       poll_interval: float = 0.05) -> dict:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            record = self.get_batch(batch_id)
            if record is not None and record.get("state") in states:
                return record
            time.sleep(poll_interval)
        raise TimeoutError(f"batch {batch_id} not in {states} in {timeout}s")

    # -- dev mode ------------------------------------------------------------

    def dev_deposit(self, amount: int, l1_seq: int = 0) -> dict:
        return self.api.dev_deposit(self.pubkey, amount, l1_seq)

    def dev_deposit_to(self, to: bytes, amount: int, l1_seq: int = 0) -> dict:
        return self.api.dev_deposit(to, amount, l1_seq)

    def dev_seal(self) -> dict:
        return self.api.dev_seal()
