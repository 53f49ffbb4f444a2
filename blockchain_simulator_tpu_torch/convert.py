"""State carried across between the JAX package and the port.

The counterpart of carrying weights across: ``state_from_numpy`` turns the
JAX package's ``PbftState`` / ``PbftBufs`` leaves (the tick engine) or
``PbftRoundState`` leaves (the round-blocked fast path), given as numpy
arrays keyed by field name, into the port's dataclasses on a device, and
``state_to_numpy`` goes the other way.  Both packages can then start from one
mid-run state.  :func:`state_digests` fingerprints every field, so two runs
can be compared without shipping the arrays.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from blockchain_simulator_tpu_torch.models import pbft, pbft_round
from blockchain_simulator_tpu_torch.runner import use_round_schedule

_TORCH_DTYPES = {np.dtype(np.int32): torch.int32, np.dtype(np.bool_): torch.bool}


def _to_tensor(name, arr, device):
    a = np.asarray(arr)
    if a.dtype not in _TORCH_DTYPES:
        raise TypeError(f"field {name!r}: dtype {a.dtype} is not int32 or bool")
    # a copy: the port updates its rings in place, and must not write into
    # the caller's (possibly read-only, possibly shared) arrays
    return torch.tensor(a, device=device)


def state_from_numpy(cfg, state: dict, bufs: dict | None, device):
    """The state the config's engine carries, on ``device``, from numpy
    leaves: ``(PbftState, PbftBufs)`` for the tick engine (``bufs=None``
    gives empty rings), ``(PbftRoundState, ())`` when the config resolves to
    the round-blocked fast path (which has no rings: ``bufs`` must be
    ``None``).  Shapes are checked against the engine's ``init``."""
    if use_round_schedule(cfg):
        if bufs:
            raise ValueError("the round-blocked fast path carries no rings")
        ref_state, _ = pbft_round.init(cfg, device="meta")
        groups = ((pbft_round.PbftRoundState, pbft_round.STATE_FIELDS,
                   ref_state, state),)
    else:
        ref_state, ref_bufs = pbft.init(cfg, device="meta")
        groups = ((pbft.PbftState, pbft.STATE_FIELDS, ref_state, state),
                  (pbft.PbftBufs, pbft.BUF_FIELDS, ref_bufs, bufs))
    out = []
    for cls, names, ref, leaves in groups:
        if leaves is None:
            out.append(pbft.init(cfg, device=device)[1])
            continue
        fields = {}
        for name in names:
            t = _to_tensor(name, leaves[name], device)
            want = getattr(ref, name)
            if t.shape != want.shape or t.dtype != want.dtype:
                raise ValueError(f"field {name!r}: got {tuple(t.shape)} {t.dtype}, "
                                 f"config needs {tuple(want.shape)} {want.dtype}")
            fields[name] = t
        out.append(cls(**fields))
    return tuple(out) if len(out) == 2 else (out[0], ())


def state_to_numpy(state, bufs=None):
    """Numpy leaves keyed by field name (either engine's state): ``state``
    alone, or ``(state, bufs)`` when ``bufs`` is given."""
    def leaves(obj):
        return {f.name: getattr(obj, f.name).detach().cpu().numpy()
                for f in dataclasses.fields(obj)}

    s = leaves(state)
    return s if bufs is None else (s, leaves(bufs))


def digest(arr) -> str:
    """sha256 over an array's dtype, shape and bytes (C order)."""
    a = np.ascontiguousarray(np.asarray(arr))
    h = hashlib.sha256(f"{a.dtype.str}{a.shape}".encode())
    h.update(a.tobytes())
    return h.hexdigest()


def state_digests(leaves: dict) -> dict:
    """``{field: sha256}`` for numpy leaves (either package's)."""
    return {k: digest(v) for k, v in sorted(leaves.items())}
