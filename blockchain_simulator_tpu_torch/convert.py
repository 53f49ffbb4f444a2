"""State carried across between the JAX package and the port.

The counterpart of carrying weights across: ``state_from_numpy`` turns the
JAX package's ``PbftState`` / ``PbftBufs`` leaves (the PBFT tick engine),
``PbftRoundState`` leaves (the round-blocked fast path), ``RaftState`` /
``RaftBufs`` leaves (the Raft tick engine, which the heartbeat path also
carries), ``PaxosState`` / ``PaxosBufs`` leaves (the Paxos tick engine) or
``MixedState`` / ``MixedBufs`` leaves (the mixed shard sim), given as numpy
arrays keyed by field name, into the port's dataclasses on a device, and
``state_to_numpy`` goes the other way.  Both packages can then start from one
mid-run state.  :func:`state_digests` fingerprints every field, so two runs
can be compared without shipping the arrays.

Lane-stacked states (a sweep's finals, every field with a leading lane axis
``[B, ...]``, the form ``jax.vmap`` returns): :func:`lanes_from_numpy` builds
one from such leaves, ``state_to_numpy`` reads one back, and
:func:`lane_leaves` takes one lane's leaves out of either package's, for
per-lane digests.

A committee run's final state (topology "committee") is stacked ``[C, ...]``,
as JAX's ``lax.map`` stacks it: ``state_from_numpy`` builds each committee's
state at the inner config from its slice and stacks them, and
``state_to_numpy`` reads the stack back as ``[C, ...]`` leaves.  The
kregular Raft edge ring ``vreq`` is ``[D, N, K]`` in both packages.

The mixed sim's leaves are keyed ``"raft.<field>"`` and ``"pbft.<field>"``,
as its two sub-states nest them.  Its Raft rings are laid out as the JAX
package's ``jax.vmap`` leaves them, ``[S, D, m, ...]``; the port keeps them
slot-major, ``[D, S, m, ...]``, and the conversion moves the axes both ways,
so the numpy side (and every digest) has JAX's layout.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from blockchain_simulator_tpu_torch.models import mixed, paxos, pbft, pbft_round, raft
from blockchain_simulator_tpu_torch.models.base import stack_lanes
from blockchain_simulator_tpu_torch.runner import use_round_schedule

_TORCH_DTYPES = {np.dtype(np.int32): torch.int32, np.dtype(np.bool_): torch.bool}


def _to_tensor(name, arr, device):
    a = np.asarray(arr)
    if a.dtype not in _TORCH_DTYPES:
        raise TypeError(f"field {name!r}: dtype {a.dtype} is not int32 or bool")
    # a copy: the port updates its rings in place, and must not write into
    # the caller's (possibly read-only, possibly shared) arrays
    return torch.tensor(np.ascontiguousarray(a), device=device)


def state_from_numpy(cfg, state: dict, bufs: dict | None, device):
    """The state the config's engine carries, on ``device``, from numpy
    leaves: ``(PbftState, PbftBufs)``, ``(RaftState, RaftBufs)`` or
    ``(PaxosState, PaxosBufs)`` for a tick engine (``bufs=None`` gives empty
    rings), ``(PbftRoundState, ())``
    when a PBFT config resolves to the round-blocked fast path (which has no
    rings: ``bufs`` must be ``None``), ``(MixedState, MixedBufs)`` for the
    mixed sim (either schedule), ``(stacked state, ())`` for a committee
    run's final state (``bufs`` must be ``None``).  Shapes are checked
    against the engine's ``init``."""
    if cfg.topology == "committee":
        return _committee_from_numpy(cfg, state, bufs, device)
    if cfg.protocol == "mixed":
        return _mixed_from_numpy(cfg, state, bufs, device)
    if cfg.protocol == "raft":
        proto = raft
        ref_state, ref_bufs = raft.init(cfg, device="meta")
        groups = ((raft.RaftState, raft.STATE_FIELDS, ref_state, state),
                  (raft.RaftBufs, raft.BUF_FIELDS, ref_bufs, bufs))
    elif cfg.protocol == "paxos":
        proto = paxos
        ref_state, ref_bufs = paxos.init(cfg, device="meta")
        groups = ((paxos.PaxosState, paxos.STATE_FIELDS, ref_state, state),
                  (paxos.PaxosBufs, paxos.BUF_FIELDS, ref_bufs, bufs))
    elif use_round_schedule(cfg):
        if bufs:
            raise ValueError("the round-blocked fast path carries no rings")
        ref_state, _ = pbft_round.init(cfg, device="meta")
        groups = ((pbft_round.PbftRoundState, pbft_round.STATE_FIELDS,
                   ref_state, state),)
    else:
        proto = pbft
        ref_state, ref_bufs = pbft.init(cfg, device="meta")
        groups = ((pbft.PbftState, pbft.STATE_FIELDS, ref_state, state),
                  (pbft.PbftBufs, pbft.BUF_FIELDS, ref_bufs, bufs))
    out = [proto.init(cfg, device=device)[1] if leaves is None
           else _fields(cls, names, ref, leaves, device)
           for cls, names, ref, leaves in groups]
    return tuple(out) if len(out) == 2 else (out[0], ())


def _committee_from_numpy(cfg, state: dict, bufs, device):
    """The stacked ``[C, ...]`` final state of a committee run, each
    committee's slice checked as the inner tick engine's state."""
    from blockchain_simulator_tpu_torch.topo import committee

    if bufs:
        raise ValueError("a committee run's final state carries no rings "
                         "(topo/committee.py stacks the inner finals only)")
    icfg = committee.inner_cfg(cfg).with_(schedule="tick")
    return stack_lanes([state_from_numpy(icfg, lane_leaves(state, i), None, device)[0]
                        for i in range(cfg.committees)]), ()


def _split(leaves: dict, part: str) -> dict:
    """The ``"<part>.<field>"`` leaves of a mixed state, keyed by field."""
    pre = part + "."
    return {k[len(pre):]: v for k, v in leaves.items() if k.startswith(pre)}


def _mixed_from_numpy(cfg, state: dict, bufs: dict | None, device):
    """``(MixedState, MixedBufs)`` from ``"raft.*"`` / ``"pbft.*"`` leaves
    (``bufs=None`` gives empty rings)."""
    ref_state, ref_bufs = mixed.init(cfg, device="meta")
    if bufs is None:
        new_bufs = mixed.init(cfg, device=device)[1]
    else:
        # JAX's [S, D, m, ...] -> slot-major [D, S, m, ...]
        r_bufs = {k: np.swapaxes(np.asarray(v), 0, 1)
                  for k, v in _split(bufs, "raft").items()}
        new_bufs = mixed.MixedBufs(
            raft=_fields(raft.RaftBufs, raft.BUF_FIELDS, ref_bufs.raft, r_bufs, device,
                         "raft"),
            pbft=_fields(pbft.PbftBufs, pbft.BUF_FIELDS, ref_bufs.pbft,
                         _split(bufs, "pbft"), device, "pbft"))
    new_state = mixed.MixedState(
        raft=_fields(raft.RaftState, raft.STATE_FIELDS, ref_state.raft,
                     _split(state, "raft"), device, "raft"),
        pbft=_fields(pbft.PbftState, pbft.STATE_FIELDS, ref_state.pbft,
                     _split(state, "pbft"), device, "pbft"))
    return new_state, new_bufs


def _fields(cls, names, ref, leaves: dict, device, part: str = ""):
    """``cls`` from numpy leaves, each checked against ``ref``'s shape and
    dtype."""
    fields = {}
    for name in names:
        label = f"{part}.{name}" if part else name
        t = _to_tensor(label, leaves[name], device)
        want = getattr(ref, name)
        if t.shape != want.shape or t.dtype != want.dtype:
            raise ValueError(f"field {label!r}: got {tuple(t.shape)} {t.dtype}, "
                             f"config needs {tuple(want.shape)} {want.dtype}")
        fields[name] = t
    return cls(**fields)


def state_to_numpy(state, bufs=None):
    """Numpy leaves keyed by field name (any engine's state): ``state``
    alone, or ``(state, bufs)`` when ``bufs`` is given.  A mixed state's
    leaves are keyed ``"raft.<field>"`` / ``"pbft.<field>"``, its Raft rings
    in JAX's ``[S, D, m, ...]`` layout."""
    def leaves(obj):
        return {f.name: getattr(obj, f.name).detach().cpu().numpy()
                for f in dataclasses.fields(obj)}

    if isinstance(state, mixed.MixedState):
        s = {f"{part}.{k}": v for part in ("raft", "pbft")
             for k, v in leaves(getattr(state, part)).items()}
        if bufs is None:
            return s
        b = {f"raft.{k}": np.swapaxes(v, 0, 1) for k, v in leaves(bufs.raft).items()}
        b.update({f"pbft.{k}": v for k, v in leaves(bufs.pbft).items()})
        return s, b
    s = leaves(state)
    return s if bufs is None else (s, leaves(bufs))


def lane_leaves(leaves: dict, i: int) -> dict:
    """Lane ``i`` of lane-stacked numpy leaves (either package's)."""
    return {k: np.asarray(v)[i] for k, v in leaves.items()}


def lanes_from_numpy(cfg, leaves: dict, device):
    """A lane-stacked final state on ``device`` from numpy leaves ``[B,
    ...]`` (JAX's vmapped finals): each lane checked as
    :func:`state_from_numpy` checks one state, then stacked."""
    n_lanes = len(next(iter(leaves.values())))
    return stack_lanes([state_from_numpy(cfg, lane_leaves(leaves, i), None, device)[0]
                        for i in range(n_lanes)])


def digest(arr) -> str:
    """sha256 over an array's dtype, shape and bytes (C order)."""
    a = np.ascontiguousarray(np.asarray(arr))
    h = hashlib.sha256(f"{a.dtype.str}{a.shape}".encode())
    h.update(a.tobytes())
    return h.hexdigest()


def state_digests(leaves: dict) -> dict:
    """``{field: sha256}`` for numpy leaves (either package's)."""
    return {k: digest(v) for k, v in sorted(leaves.items())}
