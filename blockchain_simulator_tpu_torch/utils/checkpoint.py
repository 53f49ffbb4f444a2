"""Checkpoint / resume (port of ``blockchain_simulator_tpu/utils/checkpoint.py``).

A checkpoint is the JAX package's archive, so either package resumes the
other's: a flat ``np.savez`` of the ``(state, bufs)`` leaves of the tick
engine, ``s{i}`` and ``b{i}`` in JAX's leaf order (the fields in declaration
order; the mixed sim's Raft leaves, then its PBFT leaves) and layout (the
mixed sim's Raft rings ``[S, D, m, ...]``, which the port keeps slot-major:
``convert`` moves the axis), the config as JSON (``__cfg__``, the same
string the JAX package writes), the tick (``__tick__``) and, for a
dynamic-fault run, its ``(n_crashed, n_byzantine)`` operands (``__dyn__``).
Every random draw is a pure function of (seed, tick, channel), so a resumed
run equals the uninterrupted one.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib

import numpy as np

from blockchain_simulator_tpu_torch.utils.config import FaultConfig, SimConfig


def config_to_json(cfg: SimConfig) -> str:
    return json.dumps(dataclasses.asdict(cfg))


def config_from_json(s: str) -> SimConfig:
    d = json.loads(s)
    d["faults"] = FaultConfig(**d["faults"])
    return SimConfig(**d)


def save_checkpoint(path, cfg: SimConfig, state, bufs, tick: int, dyn_counts=None) -> None:
    """Write one checkpoint: config, tick and every state and ring leaf (on
    any device).  ``dyn_counts`` — the ``(n_crashed, n_byzantine)``
    operands of a dynamic-fault run (runner.run_dyn_checkpointed) — is
    stored as ``__dyn__``; ``None`` (the static path) writes none.  The
    archive goes to a sibling tmp file, is fsynced, then ``os.replace``d, so
    a kill mid-save leaves no torn ``ckpt_*.npz``."""
    from blockchain_simulator_tpu_torch import convert

    s_leaves, b_leaves = convert.state_to_numpy(state, bufs)
    arrays = {f"s{i}": v for i, v in enumerate(s_leaves.values())}
    arrays.update({f"b{i}": v for i, v in enumerate(b_leaves.values())})
    if dyn_counts is not None:
        nc, nb = dyn_counts
        arrays["__dyn__"] = np.asarray([int(nc), int(nb)], dtype=np.int32)
    path = str(path)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            np.savez(
                f,
                __cfg__=np.frombuffer(config_to_json(cfg).encode(), dtype=np.uint8),
                __tick__=np.int64(tick),
                **arrays,
            )
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _leaf_names(cfg: SimConfig):
    """The tick engine's ``(state, bufs)`` field names in JAX's leaf order
    (``"raft.<field>"`` / ``"pbft.<field>"`` for the mixed sim)."""
    from blockchain_simulator_tpu_torch.models.base import get_protocol
    from blockchain_simulator_tpu_torch.models import pbft, raft

    if cfg.protocol == "mixed":
        parts = (("raft", raft), ("pbft", pbft))
        return ([f"{p}.{f}" for p, m in parts for f in m.STATE_FIELDS],
                [f"{p}.{f}" for p, m in parts for f in m.BUF_FIELDS])
    proto = get_protocol(cfg.protocol)
    return list(proto.STATE_FIELDS), list(proto.BUF_FIELDS)


def load_checkpoint(path, device=None):
    """Read a checkpoint back: ``(cfg, state, bufs, tick)``, the tick
    engine's state and rings on ``device`` (the card unless the caller
    passes ``device="cpu"``), each leaf checked against the config's
    shapes."""
    from blockchain_simulator_tpu_torch import convert
    from blockchain_simulator_tpu_torch.runner import resolve_device

    dev = resolve_device(device)
    with np.load(pathlib.Path(path)) as z:
        cfg = config_from_json(bytes(z["__cfg__"]).decode())
        tick = int(z["__tick__"])
        s_names, b_names = _leaf_names(cfg)
        n_s = sum(k.startswith("s") for k in z.files)
        n_b = sum(k.startswith("b") for k in z.files)
        if (n_s, n_b) != (len(s_names), len(b_names)):
            raise ValueError(f"{path}: {n_s} state and {n_b} ring leaves, the "
                             f"{cfg.protocol} tick engine has {len(s_names)} and "
                             f"{len(b_names)}")
        state = {name: z[f"s{i}"] for i, name in enumerate(s_names)}
        bufs = {name: z[f"b{i}"] for i, name in enumerate(b_names)}
    # the archive holds the tick engine's state whatever the schedule says
    state, bufs = convert.state_from_numpy(cfg.with_(schedule="tick"), state, bufs, dev)
    return cfg, state, bufs, tick


def load_dyn_counts(path):
    """The stored ``(n_crashed, n_byzantine)`` operands of a checkpoint, or
    ``None`` for a static-path archive."""
    with np.load(pathlib.Path(path)) as z:
        if "__dyn__" not in z:
            return None
        d = np.asarray(z["__dyn__"])
    return int(d[0]), int(d[1])
