"""Layered configuration: TOML files + ZL_* environment overrides.

Mirrors config/src/lib.rs: precedence ZL_CONFIG path > ./config.toml >
~/.zelana/config.toml, then ZL_* env vars override individual fields
(:332-447). The env var surface matches the reference list (:387-447).
"""

from __future__ import annotations

import os
import tomllib
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class ZelanaConfig:
    db_path: str = "./zelana-db"
    http_port: int = 8899
    udp_port: int = 9099
    udp_enabled: bool = False
    bridge_program: str = ""
    prover_mode: str = "mock"  # mock | groth16
    mock_prover: bool = True
    settlement_enabled: bool = False
    proving_key: str = ""
    verifying_key: str = ""
    noir_coordinator_url: str = ""
    sequencer_keypair: str = ""
    dev_mode: bool = True
    batch_max_txs: int = 100
    batch_max_age_secs: float = 60.0
    batch_max_shielded: int = 10

    _ENV_MAP = {
        "ZL_DB_PATH": ("db_path", str),
        "ZL_HTTP_PORT": ("http_port", int),
        "ZL_UDP_PORT": ("udp_port", int),
        "ZL_UDP_ENABLED": ("udp_enabled", lambda v: v.lower() in ("1", "true")),
        "ZL_BRIDGE_PROGRAM": ("bridge_program", str),
        "ZL_PROVER_MODE": ("prover_mode", str),
        "ZL_MOCK_PROVER": ("mock_prover", lambda v: v.lower() in ("1", "true")),
        "ZL_SETTLEMENT_ENABLED": (
            "settlement_enabled", lambda v: v.lower() in ("1", "true")),
        "ZL_PROVING_KEY": ("proving_key", str),
        "ZL_VERIFYING_KEY": ("verifying_key", str),
        "ZL_NOIR_COORDINATOR_URL": ("noir_coordinator_url", str),
        "ZL_SEQUENCER_KEYPAIR": ("sequencer_keypair", str),
        "ZL_DEV_MODE": ("dev_mode", lambda v: v.lower() in ("1", "true")),
        "ZL_BATCH_MAX_TXS": ("batch_max_txs", int),
        "ZL_BATCH_MAX_AGE_SECS": ("batch_max_age_secs", float),
        "ZL_BATCH_MAX_SHIELDED": ("batch_max_shielded", int),
    }

    @classmethod
    def load(cls, path: Optional[str] = None) -> "ZelanaConfig":
        cfg = cls()
        candidates = []
        if path:
            candidates.append(path)
        if os.environ.get("ZL_CONFIG"):
            candidates.append(os.environ["ZL_CONFIG"])
        candidates.append("./config.toml")
        candidates.append(os.path.expanduser("~/.zelana/config.toml"))
        for cand in candidates:
            if cand and os.path.exists(cand):
                with open(cand, "rb") as f:
                    data = tomllib.load(f)
                for key, value in data.items():
                    if hasattr(cfg, key) and not key.startswith("_"):
                        setattr(cfg, key, value)
                break
        for env, (attr, conv) in cls._ENV_MAP.items():
            if env in os.environ:
                setattr(cfg, attr, conv(os.environ[env]))
        return cfg
