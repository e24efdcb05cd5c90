"""Server-side delegated ownership proving on the card (the coordinator's
ownership API, forge/crates/prover-coordinator/src/ownership_api.rs:1-45).

Synchronous `POST /v2/ownership/prove`: the client ships the private
witness (spending key, value, blinding, position) plus the expected
commitment/nullifier/blinded-proxy; the server recomputes the public
values, REJECTS mismatches, proves the OwnershipCircuit with the Groth16
engine, and returns a sunspot-shaped 388-byte proof with the 3 public
inputs -- exactly the shape the reference returns from its nargo+sunspot
run. The contrast with the client-side WASM path (sdk ownership-prover)
is preserved: same relation, server compute.

Keygen and proofs run through the port's kernels on `device` ("cuda" by
default; with no card this raises unless the caller asks for "cpu")."""

from __future__ import annotations

import threading
import time
from typing import List, Optional

from ..circuits.ownership import OwnershipCircuit
from ..device import resolve
from ..groth16.keys import ProvingKey
from ..hashes import mimc
from .chunk_prover import sunspot_proof_bytes, sunspot_public_witness


class OwnershipProver:
    """One proving key for the fixed ownership relation; thread-safe lazy
    keygen (the circuit shape is witness-independent, so one key serves
    every request -- the property the worker fleet relies on)."""

    def __init__(self, pk: Optional[ProvingKey] = None, device="cuda"):
        self.pk = pk
        self.device = resolve(device)
        self._lock = threading.Lock()

    def ensure_keys(self) -> ProvingKey:
        with self._lock:
            if self.pk is None:
                from ..groth16.setup import keygen

                dummy = OwnershipCircuit.from_witness(1, 1, 1, 0)
                self.pk = keygen(dummy, seed=0, device=self.device)
            return self.pk

    def prove(self, spending_key: int, value: int, blinding: int,
              position: int, expected_commitment: Optional[int] = None,
              expected_nullifier: Optional[int] = None,
              expected_proxy: Optional[int] = None) -> dict:
        pk_val = mimc.derive_public_key(spending_key)
        cm = mimc.compute_commitment(pk_val, value, blinding)
        nf = mimc.compute_nullifier(spending_key, cm, position)
        bp = mimc.compute_blinded_proxy(cm, position)
        for expected, got, name in (
            (expected_commitment, cm, "commitment"),
            (expected_nullifier, nf, "nullifier"),
            (expected_proxy, bp, "blinded_proxy"),
        ):
            if expected is not None and int(expected) != int(got):
                raise ValueError(f"{name} mismatch: witness does not "
                                 f"produce the expected value")
        pk = self.ensure_keys()
        from ..groth16.prove import prove as groth16_prove

        start = time.time()
        circuit = OwnershipCircuit.from_witness(
            spending_key, value, blinding, position)
        proof = groth16_prove(pk, circuit, batch_id=0, device=self.device)
        values = [int(cm), int(nf), int(bp)]
        return {
            "proof": sunspot_proof_bytes(proof).hex(),
            "public_inputs": [str(v) for v in values],
            "public_witness": sunspot_public_witness(values).hex(),
            "proving_time_ms": int((time.time() - start) * 1000),
        }

    def verify(self, proof_bytes: bytes, public_inputs: List[int]) -> bool:
        """Verify a delegated ownership proof (the sequencer-side check the
        reference leaves TODO at api/handlers.rs:352-353)."""
        from ..groth16.verify import verify as groth16_verify
        from ..sequencer.prover_service import solana_bytes_to_proof

        if self.pk is None or len(proof_bytes) < 256:
            return False
        proof = solana_bytes_to_proof(proof_bytes[:256])
        return groth16_verify(self.pk.vk, proof, list(public_inputs))
