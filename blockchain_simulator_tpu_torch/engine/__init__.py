"""The C++ reference engine, wrapped without jax (port of
``blockchain_simulator_tpu/engine/__init__.py``).

``engine.cpp`` is a byte-for-byte copy of the JAX package's engine: a serial,
per-message discrete-event simulator, architecturally independent of the
tensorized engines, which the differential tests hold them against
(``tests/test_torch_engine.py`` pins the copy's sha256 to the original).  It
is CPU code and needs no card.  It is compiled at first use with ``g++ -O2
-std=c++17 -shared -fPIC`` into ``build/`` beside this package (rebuilt when
the source is newer) and called through ctypes with a flat config struct;
results come back as a JSON metrics string with the same keys as the
protocol's ``metrics()`` dict.
"""

from __future__ import annotations

import ctypes
import json
import os
import pathlib
import subprocess
import tempfile
import threading

_DIR = pathlib.Path(__file__).resolve().parent
_SRC = _DIR / "engine.cpp"
BUILD_DIR = _DIR.parent / "build"
_LIB = BUILD_DIR / "libengine.so"

_PROTOCOLS = {"pbft": 0, "raft": 1, "paxos": 2}


class _CppCfg(ctypes.Structure):
    # field order must match struct SimCfg in engine.cpp
    _fields_ = [
        ("protocol", ctypes.c_int32),
        ("n", ctypes.c_int32),
        ("sim_ms", ctypes.c_int32),
        ("seed", ctypes.c_int64),
        ("fidelity", ctypes.c_int32),
        ("delay_lo", ctypes.c_int32),
        ("delay_hi", ctypes.c_int32),
        ("pbft_interval", ctypes.c_int32),
        ("pbft_max_rounds", ctypes.c_int32),
        ("pbft_slots", ctypes.c_int32),
        ("pbft_vc_num", ctypes.c_int32),
        ("pbft_vc_den", ctypes.c_int32),
        ("raft_hb", ctypes.c_int32),
        ("raft_elo", ctypes.c_int32),
        ("raft_ehi", ctypes.c_int32),
        ("raft_prop_delay", ctypes.c_int32),
        ("raft_max_blocks", ctypes.c_int32),
        ("raft_max_rounds", ctypes.c_int32),
        ("paxos_p", ctypes.c_int32),
        ("paxos_max_ticket", ctypes.c_int32),
        ("paxos_timeout", ctypes.c_int32),
        ("n_crashed", ctypes.c_int32),
        ("n_byzantine", ctypes.c_int32),
        ("drop_prob", ctypes.c_double),
        ("ser_pbft", ctypes.c_int32),
        ("ser_raft", ctypes.c_int32),
        ("queued_links", ctypes.c_int32),
        ("link_prop", ctypes.c_int32),
        ("echo", ctypes.c_int32),
        ("paxos_client_node", ctypes.c_int32),
        ("paxos_client_ms", ctypes.c_int32),
    ]


def build(force: bool = False) -> pathlib.Path:
    """Compile the engine if missing or stale; returns the .so path."""
    if force or not _LIB.exists() or _LIB.stat().st_mtime < _SRC.stat().st_mtime:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # compile to a temp file and os.replace() it: concurrent builds
        # (parallel pytest workers) never load a partially written .so
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-o", tmp, str(_SRC)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(f"engine compilation failed (g++ exit "
                                   f"{proc.returncode}):\n{proc.stderr}")
            os.chmod(tmp, 0o755)  # mkstemp creates 0600; keep the .so loadable
            os.replace(tmp, _LIB)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return _LIB


_lib_handle = None
_lock = threading.Lock()


def _lib():
    global _lib_handle
    with _lock:
        if _lib_handle is None:
            handle = ctypes.CDLL(str(build()))
            handle.run_sim.argtypes = [ctypes.POINTER(_CppCfg), ctypes.c_char_p,
                                       ctypes.c_int]
            handle.run_sim.restype = ctypes.c_int
            _lib_handle = handle
    return _lib_handle


def cpp_config(cfg, seed: int | None = None) -> _CppCfg:
    """Map a ``SimConfig`` onto the engine's flat config struct, refusing
    what the engine does not model (as the JAX package's wrapper does)."""
    if cfg.protocol not in _PROTOCOLS:
        raise ValueError(f"the C++ engine implements {sorted(_PROTOCOLS)}; "
                         f"protocol {cfg.protocol!r} is tensor-engine only")
    if cfg.topology != "full":
        raise ValueError("the C++ engine simulates the full mesh only; "
                         f"topology {cfg.topology!r} is tensor-engine only")
    if cfg.quorum_rule != "n2":
        raise ValueError("the C++ engine implements the reference's n2 majority "
                         f"counting only; quorum_rule {cfg.quorum_rule!r} is "
                         "tensor-engine only")
    if cfg.faults.byz_forge:
        raise ValueError("the C++ engine does not implement the byz_forge attack")
    lo, hi = cfg.one_way_range()
    if cfg.protocol == "paxos" and cfg.fidelity == "clean":
        # clean-fidelity paxos relies on stale same-type replies draining
        # before a retry window opens
        _, rt_hi = cfg.roundtrip_range()
        if cfg.paxos_retry_timeout_ms < rt_hi:
            raise ValueError(
                f"paxos_retry_timeout_ms={cfg.paxos_retry_timeout_ms} must be "
                f">= the max reply horizon ({rt_hi} ms): clean-fidelity "
                "correctness relies on abandoned windows draining before retry")
    return _CppCfg(
        protocol=_PROTOCOLS[cfg.protocol],
        n=cfg.n,
        sim_ms=cfg.sim_ms,
        seed=cfg.seed if seed is None else seed,
        fidelity=1 if cfg.fidelity == "clean" else 0,
        delay_lo=lo,
        delay_hi=hi,
        pbft_interval=cfg.pbft_block_interval_ms,
        pbft_max_rounds=cfg.pbft_max_rounds,
        pbft_slots=cfg.pbft_max_slots,
        pbft_vc_num=cfg.pbft_view_change_num,
        pbft_vc_den=cfg.pbft_view_change_den,
        raft_hb=cfg.raft_heartbeat_ms,
        raft_elo=cfg.raft_election_lo_ms,
        raft_ehi=cfg.raft_election_hi_ms,
        raft_prop_delay=cfg.raft_proposal_delay_ms,
        raft_max_blocks=cfg.raft_max_blocks,
        raft_max_rounds=cfg.raft_max_rounds,
        paxos_p=cfg.paxos_n_proposers,
        paxos_max_ticket=cfg.paxos_max_ticket,
        paxos_timeout=cfg.paxos_retry_timeout_ms,
        n_crashed=cfg.faults.resolved_n_crashed(cfg.n),
        n_byzantine=cfg.faults.n_byzantine,
        drop_prob=cfg.faults.drop_prob,
        ser_pbft=cfg.serialization_ticks(cfg.pbft_block_bytes),
        ser_raft=cfg.serialization_ticks(cfg.raft_block_bytes),
        echo=1 if cfg.echo_back else 0,
        paxos_client_node=cfg.paxos_client_node,
        paxos_client_ms=cfg.paxos_client_ms,
        queued_links=1 if cfg.queued_links else 0,
        link_prop=cfg.link_delay_ms,
    )


def run_cpp(cfg, seed: int | None = None) -> dict:
    """Run one simulation on the C++ engine; returns the metrics dict (the
    keys of the matching protocol's ``metrics()``)."""
    c = cpp_config(cfg, seed)
    buf = ctypes.create_string_buffer(4096)
    rc = _lib().run_sim(ctypes.byref(c), buf, len(buf))
    if rc != 0:
        raise RuntimeError(f"engine run_sim failed with code {rc}")
    return json.loads(buf.value.decode())
