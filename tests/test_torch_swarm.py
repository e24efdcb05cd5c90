"""The port's MPC swarm (zelana_tpu_torch.sdk.mpc, runtime.prover_node and
runtime.control) against the JAX package's, on the CPU. Equality is exact.

Under one random stream the two packages draw the same Shamir shares,
nonces and proofs; Lagrange coefficients and reconstructions are equal.
Over HTTP the port's NodeNetworkCoordinator drives JAX nodes and the JAX
coordinator drives the port's nodes, and each proof verifies in both
packages. The port's SwarmController spawns the port's `node` command,
never the JAX package's.
"""

import json
import os
import urllib.error
import urllib.request

import pytest
import torch

import zelana_tpu.runtime.prover_node as JN
import zelana_tpu.sdk.mpc as JM
import zelana_tpu_torch.runtime.prover_node as TN
import zelana_tpu_torch.sdk.mpc as TM
from zelana_tpu_torch.runtime.control import SwarmController

torch.set_num_threads(1)


def seeded(monkeypatch, seed):
    """One deterministic os.urandom stream from `seed` (both packages draw
    their field elements from os.urandom)."""
    import hashlib

    state = {"i": 0}

    def urandom(n):
        out = b""
        while len(out) < n:
            out += hashlib.sha256(seed + state["i"].to_bytes(8, "little")
                                  ).digest()
            state["i"] += 1
        return out[:n]

    monkeypatch.setattr(os, "urandom", urandom)


@pytest.mark.parametrize("k,n", [(1, 1), (2, 3), (3, 5)])
def test_shamir_matches_jax(monkeypatch, k, n):
    secret = 123456789123456789 * (k + n)
    seeded(monkeypatch, b"shamir")
    tshares = TM.share_secret(secret, k, n)
    seeded(monkeypatch, b"shamir")
    jshares = JM.share_secret(secret, k, n)
    assert [(s.index, s.value) for s in tshares] == [
        (s.index, s.value) for s in jshares]
    for subset in (tshares[:k], tshares[n - k:]):
        idx = [s.index for s in subset]
        assert ([TM.lagrange_coefficient(idx, i) for i in idx]
                == [JM.lagrange_coefficient(idx, i) for i in idx])
        assert TM.reconstruct(subset) == secret
    assert TM.public_key(secret) == JM.public_key(secret)


def test_distributed_schnorr_matches_jax(monkeypatch):
    msg = b"zelana batch 42"
    seeded(monkeypatch, b"schnorr")
    tproof, tpk = TM.distributed_schnorr_prove(987654321, msg, k=3, n=5)
    seeded(monkeypatch, b"schnorr")
    jproof, jpk = JM.distributed_schnorr_prove(987654321, msg, k=3, n=5)
    assert (tproof.r_point, tproof.z, tpk) == (jproof.r_point, jproof.z, jpk)
    assert tproof.verify(tpk, msg)
    assert JM.SchnorrProof(tproof.r_point, tproof.z).verify(tpk, msg)
    assert not tproof.verify(tpk, msg + b"!")
    assert not tproof.verify(TM.public_key(987654322), msg)
    seeded(monkeypatch, b"preimage")
    th = TM.prove_hash_preimage(b"the witness", k=2, n=3)
    seeded(monkeypatch, b"preimage")
    jh = JM.prove_hash_preimage(b"the witness", k=2, n=3)
    assert (th.commitment, th.schnorr.r_point, th.schnorr.z,
            th.hash_value) == (jh.commitment, jh.schnorr.r_point,
                               jh.schnorr.z, jh.hash_value)
    assert TM.verify_hash_preimage(th, b"the witness")
    assert not TM.verify_hash_preimage(th, b"wrong witness")


def post(url, path, body):
    req = urllib.request.Request(url + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def swarm(node_pkg, coord_pkg, monkeypatch) -> list:
    """Five `node_pkg` nodes over HTTP, driven by `coord_pkg`'s
    coordinator: a 3-of-5 proof, then the refusals (a replayed share, a
    fragment before a commitment, an unknown route) and the health
    answers."""
    servers, urls = [], []
    try:
        for i in range(5):
            server, port, _ = node_pkg.start_prover_node(i + 1)
            servers.append(server)
            urls.append(f"http://127.0.0.1:{port}")
        seeded(monkeypatch, b"swarm")
        proof, pk = coord_pkg.NodeNetworkCoordinator(urls).prove(
            0xDEADBEEFCAFE, b"zelana swarm proof", k=3, session_id="s1")
        out = [
            TM.SchnorrProof(proof.r_point, proof.z).verify(
                pk, b"zelana swarm proof"),
            JM.SchnorrProof(proof.r_point, proof.z).verify(
                pk, b"zelana swarm proof"),
            proof.verify(pk, b"other message"), pk,
            post(urls[0], "/share", {"session_id": "s1",
                                     "circuit": "schnorr", "index": 1,
                                     "share_value": "01"}),
            post(urls[4], "/fragment", {"session_id": "s1",
                                        "challenge": "02",
                                        "lagrange": "01"}),
            post(urls[1], "/nope", {}),
        ]
        out += [json.loads(urllib.request.urlopen(u + "/health").read())
                for u in urls]
        return out
    finally:
        for s in servers:
            s.shutdown()
            s.server_close()


def test_prover_nodes_across_packages(monkeypatch):
    want = swarm(JN, JN, monkeypatch)
    assert want[:3] == [True, True, False]
    assert want[4][0] == 400 and want[5][0] == 400
    assert swarm(JN, TN, monkeypatch) == want
    assert swarm(TN, JN, monkeypatch) == want


def test_node_state_matches_jax(monkeypatch):
    """The endpoint logic without HTTP: the same share, nonce and
    challenge give the same commitment and fragment."""
    from zelana_tpu.runtime import messages as JMSG
    from zelana_tpu_torch.runtime import messages as TMSG

    out = []
    for node, msg in ((JN, JMSG), (TN, TMSG)):
        monkeypatch.setattr(node.secrets, "randbelow", lambda n: 41)
        state = node.ProverNodeState(7)
        share = msg.ShareRequest("s", msg.CircuitType.SCHNORR, 2,
                                 msg.fr_to_hex(12345))
        got = [state.assign_share(share).to_json(),
               state.assign_share(share).to_json(),
               state.commitment(msg.CommitmentRequest("s")).to_json(),
               state.fragment(msg.FragmentRequest(
                   "s", msg.fr_to_hex(99), msg.fr_to_hex(5))).to_json()]
        with pytest.raises(KeyError):
            state.fragment(msg.FragmentRequest("s", "01", "01"))
        with pytest.raises(KeyError):
            state.commitment(msg.CommitmentRequest("t"))
        out.append(got)
    assert out[0] == out[1]


def test_swarm_controller_spawns_port_nodes(tmp_path):
    """SwarmController boots port `node` processes (`python -m
    zelana_tpu_torch.cli --device cpu node`), reports status and logs,
    and the JAX coordinator proves over them."""
    ctl = SwarmController(log_dir=str(tmp_path), device="cpu")
    try:
        urls = [ctl.start_node(i + 1).url for i in range(2)]
        for svc in ctl.services.values():
            assert svc.process.args[1:5] == ["-m", "zelana_tpu_torch.cli",
                                             "--device", "cpu"]
        status = ctl.status()
        assert sorted(status) == ["node1", "node2"]
        assert all(s["running"] and s["kind"] == "node"
                   for s in status.values())
        assert "prover node 1: http://127.0.0.1:" in ctl.logs("node1")
        proof, pk = JN.NodeNetworkCoordinator(urls).prove(
            secret=424242, message=b"ctl swarm", k=2)
        assert TM.SchnorrProof(proof.r_point, proof.z).verify(
            pk, b"ctl swarm")
        proc = ctl.services["node2"].process
        ctl.stop("node2")
        assert "node2" not in ctl.status() and proc.poll() is not None
    finally:
        ctl.stop()
    assert ctl.status() == {}
