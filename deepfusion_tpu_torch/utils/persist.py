"""Dataclass-config (de)serialization for the ops' save/load.

A saved op is its packed operands plus its frozen config in one ``.npz``
archive. Configs are frozen dataclasses whose only non-JSON field types are
``dtype`` and ``round_mode`` (encoded by name) and tuples (encoded as lists).
"""
from __future__ import annotations

import dataclasses
import json

from ..types import dtype, round_mode


def config_to_jsonable(cfg) -> dict:
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if isinstance(v, dtype):
            v = {"__dtype__": v.name}
        elif isinstance(v, round_mode):
            v = {"__round__": v.name}
        elif isinstance(v, tuple):
            v = list(v)
        out[f.name] = v
    return out


def config_from_jsonable(cls, d: dict):
    kw = {}
    for f in dataclasses.fields(cls):
        v = d[f.name]
        if isinstance(v, dict) and "__dtype__" in v:
            v = dtype[v["__dtype__"]]
        elif isinstance(v, dict) and "__round__" in v:
            v = round_mode[v["__round__"]]
        elif isinstance(v, list):
            v = tuple(v)
        kw[f.name] = v
    return cls(**kw)


def dump_config(cfg) -> str:
    return json.dumps(config_to_jsonable(cfg))


def load_config(blob, cls):
    return config_from_jsonable(cls, json.loads(str(blob)))


def dump_configs(**cfgs) -> str:
    """Named configs -> one JSON string (stored as an .npz scalar entry)."""
    return json.dumps({k: config_to_jsonable(v) for k, v in cfgs.items()})


def load_configs(blob, **classes) -> dict:
    """Inverse of dump_configs; classes maps name -> dataclass type."""
    d = json.loads(str(blob))
    return {k: config_from_jsonable(cls, d[k]) for k, cls in classes.items()}
