"""Gather-based sparse delivery: neighbour-index tables instead of N x N
(port of ``blockchain_simulator_tpu/ops/gatherdeliv.py``).

The ``topology="kregular"`` twin of ops/delivery.py.  Every primitive takes
the circulant overlay tables of topo/spec.py — ``[N, K]`` rows of global
node ids, K = degree + 1 (the self slot rides along and is masked) — and
costs O(N·K) a tick where the dense primitive costs O(N²): delays are drawn
slot-major ``[K, N]``, and sender-side values reach receivers through
gathers.  No primitive scatters, not even the reply channels, which route
requester-side through the ``inslot`` cross-index.

Each function draws from the same key, at the same shape and with the same
folds (``0x0D0D``, ``0x0D0E``, ``0x0D0F`` for the edge drops,
``0x0D10``..``0x0D14`` for the stat ones) as its dense twin in
ops/delivery.py, and every mask and reduction runs over the same index set.
So at k = N-1, where the sorted tables are the identity, a kregular run
equals the dense run bit for bit, and at any degree it equals the JAX
function.

The tables are int64 tensors on the run's device (topo/spec.device_tables
converts them once per config and device).  The JAX ``push_*`` function
pushes straight into its ring; the port's returns the contribution, which
the caller hands to the tick's one grouped ring push, as ops/delivery.py
does.

SPMD: the convention of ops/delivery.py.  ``axis`` names the mesh axis
(None: unsharded): receiver rows stay local and cross-row neighbour reads
globalize the sender-side values with an all_gather (:func:`_nbr_rows`),
or, with ``xg=`` (parallel/partition.NeighborExchange, the sharded
overlay's), with one owner-bucketed all_to_all a read.  The sharded overlay
runs its mesh in global view (parallel/partition.partition's explicit
shardings): the keys are the single-device program's and every draw here
is this rank's rows of the single-device draw (ops/delivery.draw_rows),
so the run equals the single-device run bit for bit.

Lanes (the tick engines' lane axis, models/base.py): lane keys ``[L, 2]``
with sender tensors ``[L, N, ...]`` give ``[B, L, ...]``, every lane over
the same ``[N, K]`` tables, as ops/delivery.py's lane forms do (unsharded).
"""

from __future__ import annotations

import numpy as np
import torch

from blockchain_simulator_tpu_torch.ops import delivery as dv
from blockchain_simulator_tpu_torch.ops.delay import sample_bucket_counts, sample_edge_delays
from blockchain_simulator_tpu_torch.topo import spec as topo_spec
from blockchain_simulator_tpu_torch.utils import threefry

_I32 = torch.int32


# ------------------------------------------------------------- tables -------


def table_operands(cfg, inslot: bool = False):
    """The full overlay tables of ``cfg`` as host numpy arrays: ``(in, out)``
    or ``(in, out, inslot)``, each int32 ``[N, K]``, deterministic in
    ``(n, degree, topo_seed)``."""
    args = (cfg.n, cfg.degree, cfg.topo_seed)
    tabs = [topo_spec.in_table(*args), topo_spec.out_table(*args)]
    if inslot:
        tabs.append(topo_spec.inslot_table(*args))
    return tuple(tabs)


def _as_index(t, device) -> torch.Tensor:
    """A table as an int64 tensor on ``device`` (no copy when it is one)."""
    if isinstance(t, torch.Tensor):
        return t.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(t), dtype=torch.int64, device=device)


def local_tables(cfg, ids, inslot: bool = False, tables=None, base: int = 0,
                 device=None):
    """The overlay tables of ``cfg`` at this run's rows: ``(in, out)`` or
    ``(in, out, inslot)``, int64 tensors whose values are global node ids
    (``inslot`` values are slot indices).  ``ids`` selects rows (``ids +
    base``); ``ids=None`` passes the tables through whole.  ``tables=None``
    takes the config's tables (converted once per config and device);
    given tables (numpy or tensors, :func:`table_operands`) are used
    instead, with the same values.  The device is ``ids``'s, else
    ``device`` (the CPU by default)."""
    dev = ids.device if ids is not None else torch.device(device or "cpu")
    if tables is None:
        tabs = topo_spec.device_tables(cfg.n, cfg.degree, cfg.topo_seed, dev)
        tables = tabs if inslot else tabs[:2]
    elif len(tables) != (3 if inslot else 2):
        raise ValueError(
            f"local_tables: expected {3 if inslot else 2} tables for "
            f"inslot={inslot}, got {len(tables)}"
        )
    tables = tuple(_as_index(t, dev) for t in tables)
    if ids is None:
        return tables
    rows = (ids if base == 0 else ids + base).to(torch.int64)
    return tuple(t.index_select(0, rows) for t in tables)


def _nbr_rows(x, idx_loc, axis=None, xg=None, kind="in", col=None, lanes=False):
    """Every cross-row neighbour read goes through this one door: the rows
    of ``x`` at the global ids ``idx_loc`` (``[N, K]``), i.e. ``x[idx_loc]``
    of shape ``[N, K, ...]``, or with ``col`` (``[N, K]`` column picks into
    a 2-D ``x``) the elementwise ``x.reshape(-1)[idx_loc * x.shape[1] +
    col]``, in int64 (at n = 10^6 the flat index passes 2^31 for wide
    ``x``).  ``kind`` names the table the ids follow (the exchange's plan).
    Sharded: ``x`` is globalized with an all_gather first, or with ``xg``
    only the owner-bucketed rows travel.  With ``lanes`` (unsharded) ``x``
    leads with a lane axis ``[L, N, ...]``, read lane by lane over the same
    ids: ``[L, N, K, ...]``."""
    if lanes:
        if axis is not None or xg is not None:
            raise NotImplementedError("the lane forms of the overlay reads run unsharded")
        idx = idx_loc.to(torch.int64)
        if col is None:
            return x.index_select(1, idx.reshape(-1)).reshape(
                x.shape[:1] + idx.shape + x.shape[2:])
        flat = idx * x.shape[2] + col.to(torch.int64)
        return x.reshape(x.shape[0], -1).index_select(1, flat.reshape(-1)).reshape(
            x.shape[:1] + flat.shape)
    if xg is not None:
        return xg(x, kind=kind, col=col)
    x = dv._gather(x, axis)
    idx = idx_loc.to(torch.int64)
    if col is None:
        return x.index_select(0, idx.reshape(-1)).reshape(idx.shape + x.shape[1:])
    flat = idx * x.shape[1] + col.to(torch.int64)
    return x.reshape(-1).index_select(0, flat.reshape(-1)).reshape(flat.shape)


def _notself(nbr_loc, ids) -> torch.Tensor:
    """[N, K] int32: 1 where the slot holds another node than the row's."""
    return (nbr_loc != ids[:, None]).to(_I32)


# ------------------------------------------------------------ gather sums ---


def in_counts(x, nbr_in_loc, ids, axis=None, xg=None):
    """Per-receiver sum of an int/bool ``[N]`` vector over its true
    in-neighbours (self excluded): the kregular replacement for the dense
    stat chains' ``total - own`` sender counts.  [N]."""
    vals = _nbr_rows(x.to(_I32), nbr_in_loc, axis, xg, lanes=x.ndim > 1)  # [N, K]
    return (vals * _notself(nbr_in_loc, ids)).sum(-1, dtype=_I32)


def out_counts(x, nbr_out_loc, ids, axis=None, xg=None):
    """Per-sender count of its out-neighbours inside a mask ``x`` (self
    excluded): the gathered ``n_peers`` of the round-trip stat chains.  [N]."""
    vals = _nbr_rows(x.to(_I32), nbr_out_loc, axis, xg, "out", lanes=x.ndim > 1)
    return (vals * _notself(nbr_out_loc, ids)).sum(-1, dtype=_I32)


# ------------------------------------------------- edge-exact (slot-major) ---


def _slot_hits(key, src_act, nbr_in_loc, ids, lo, hi, drop, axis, impl):
    """[B, K, N] 0/1 delivery indicators, the slot-major twin of the dense
    ``[B, N_send, N_recv]``: delays and drops are ``[K, N]`` on the SAME key,
    so at K = N (identity tables) the arrays are the dense ones.
    ``src_act`` is the ``[N, K]`` int32 send flag of each slot's source
    (self slot not yet masked; the mask lands here)."""
    dev = src_act.device
    n_loc, k1 = nbr_in_loc.shape
    k = dv._shard_key(key, axis)
    with dv.draw_rows(axis, -1):
        d = sample_edge_delays(k, (k1, n_loc), lo, hi, dev, impl)
        mask = src_act.transpose(-1, -2) * _notself(nbr_in_loc, ids).T
        if drop > 0.0:
            keep = threefry.bernoulli(threefry.fold_in(k, 0x0D0D), 1.0 - drop, (k1, n_loc),
                                      dev)
            mask = mask * keep.to(_I32)
    return (d[None] == dv._bucket_iota(lo, hi, d.ndim, dev)).to(_I32) * mask[None]


def bcast_counts_kreg(key, send, nbr_in_loc, ids, lo, hi, drop=0.0, axis=None,
                      impl="threefry", xg=None):
    """Overlay broadcast -> per-receiver arrival counts.  [B, N]."""
    src_act = _nbr_rows(send.to(_I32), nbr_in_loc, axis, xg, lanes=send.ndim > 1)
    return _slot_hits(key, src_act, nbr_in_loc, ids, lo, hi, drop, axis,
                      impl).sum(-2, dtype=_I32)


def bcast_value_max_kreg(key, send, value, nbr_in_loc, ids, lo, hi, drop=0.0,
                         axis=None, impl="threefry", xg=None):
    """Overlay value broadcast (>0; 0 = empty), max-combined.  [B, N]."""
    lanes = send.ndim > 1
    src_act = _nbr_rows(send.to(_I32), nbr_in_loc, axis, xg, lanes=lanes)
    hits = _slot_hits(key, src_act, nbr_in_loc, ids, lo, hi, drop, axis, impl)
    val_t = _nbr_rows(value.to(_I32), nbr_in_loc, axis, xg, lanes=lanes).transpose(-1, -2)
    return (hits * val_t[None]).amax(-2)


def bcast_slots_kreg(key, slot_mat, nbr_in_loc, ids, lo, hi, drop=0.0,
                     axis=None, impl="threefry", xg=None):
    """Overlay slot-keyed broadcast (PBFT COMMIT waves): arrival counts per
    (receiver, slot) gathered over in-neighbours.  [B, N, S].

    The JAX function is the int32 ``einsum("bkj,jks->bjs")``; here it is an
    int32 product summed over the K slots, exact as the JAX integer
    contraction is (no float matmul).  The sender flag is derived after the
    row read (``max`` over the slot dim commutes with a row gather)."""
    slot_rows = _nbr_rows(slot_mat.to(_I32), nbr_in_loc, axis, xg,
                          lanes=slot_mat.ndim > 2)                   # [N, K, S]
    src_act = (slot_rows.amax(-1) > 0).to(_I32)                      # [N, K]
    hits = _slot_hits(key, src_act, nbr_in_loc, ids, lo, hi, drop, axis, impl)
    return (hits.transpose(-1, -2)[..., None] * slot_rows[None]).sum(-2, dtype=_I32)


def bcast_window_value_max_kreg(key, value_mat, nbr_in_loc, ids, lo, hi,
                                drop=0.0, axis=None, impl="threefry", xg=None):
    """Overlay per-window value broadcast (PBFT PRE_PREPARE), receiver
    max-combines per window.  [B, N, W]."""
    val_rows = _nbr_rows(value_mat.to(_I32), nbr_in_loc, axis, xg,
                         lanes=value_mat.ndim > 2)                   # [N, K, W]
    src_act = (val_rows.amax(-1) > 0).to(_I32)
    hits = _slot_hits(key, src_act, nbr_in_loc, ids, lo, hi, drop, axis, impl)
    return (hits.transpose(-1, -2)[..., None] * val_rows[None]).amax(-2)


def bcast_matrix_kreg(key, send, value, nbr_in_loc, ids, lo, hi, drop=0.0,
                      axis=None, impl="threefry", xg=None):
    """Identity-preserving overlay broadcast (Raft VOTE_REQ): ``value``
    lands at ``[b, receiver, in_slot]``, the K-slot twin of the dense
    ``[B, N, N]`` matrix channel.  Slot s of receiver j is sender
    ``nbr_in_loc[j, s]`` (rows sorted, so the lowest slot is the lowest
    candidate id).  [B, N, K], contiguous (the ring push takes contiguous
    contributions)."""
    lanes = send.ndim > 1
    src_act = _nbr_rows(send.to(_I32), nbr_in_loc, axis, xg, lanes=lanes)
    hits = _slot_hits(key, src_act, nbr_in_loc, ids, lo, hi, drop, axis, impl)
    val_t = _nbr_rows(value.to(_I32), nbr_in_loc, axis, xg, lanes=lanes).transpose(-1, -2)
    return (hits * val_t[None]).transpose(-1, -2).contiguous()


def roundtrip_reply_counts_kreg(key, send, nbr_out_loc, ids, lo, hi, drop=0.0,
                                peer_mask=None, axis=None, impl="threefry",
                                xg=None):
    """Short-circuited overlay round trip: sender i reaches its
    out-neighbours, every eligible peer replies at once with an independent
    return delay.  [B2, N], offset 2*lo."""
    dev = send.device
    n_loc, k1 = nbr_out_loc.shape
    peers = torch.ones((n_loc,), dtype=torch.bool, device=dev) if peer_mask is None \
        else peer_mask
    k = dv._shard_key(key, axis)
    with dv.draw_rows(axis, -2):
        d1 = sample_edge_delays(threefry.fold_in(k, 1), (n_loc, k1), lo, hi, dev, impl)
        d2 = sample_edge_delays(threefry.fold_in(k, 2), (n_loc, k1), lo, hi, dev, impl)
    total = d1 + d2
    mask = (send.to(_I32)[..., None] * _notself(nbr_out_loc, ids)
            * _nbr_rows(peers.to(_I32), nbr_out_loc, axis, xg, "out", lanes=peers.ndim > 1))
    if drop > 0.0:
        with dv.draw_rows(axis, -2):
            keep = threefry.bernoulli(threefry.fold_in(k, 0x0D0E), (1.0 - drop) ** 2,
                                      (n_loc, k1), dev)
        mask = mask * keep.to(_I32)
    lo2 = 2 * lo
    nb = 2 * (hi - lo) - 1
    hit = (total[None] == dv._bucket_iota(lo2, lo2 + nb, total.ndim, dev)).to(_I32)
    return (hit * mask[None]).sum(-1, dtype=_I32)


def unicast_reply_counts_kreg(key, reply_slots, nbr_in_loc, nbr_out_loc,
                              inslot_loc, ids, lo, hi, drop=0.0, axis=None,
                              impl="threefry", xg=None):
    """Route per-(replier, in-slot) reply counts back to each requester
    without a scatter: requester c gathers slot ``inslot_loc[c, s]`` of
    replier ``nbr_out_loc[c, s]``.  Delay and drop tensors are
    replier-major ``[N, K]`` on the dense function's key and fold, so at
    K = N they equal the dense ``[N, N]`` draws.  [B, N]."""
    dev = reply_slots.device
    n_loc, k1 = reply_slots.shape[-2:]
    lanes = reply_slots.ndim > 2
    k = dv._shard_key(key, axis)
    with dv.draw_rows(axis, -2):
        d = sample_edge_delays(k, (n_loc, k1), lo, hi, dev, impl)
        mask = _notself(nbr_in_loc, ids)
        if drop > 0.0:
            keep = threefry.bernoulli(threefry.fold_in(k, 0x0D0F), 1.0 - drop, (n_loc, k1),
                                      dev)
            mask = mask * keep.to(_I32)
    r = reply_slots.to(_I32) * mask
    rv = _nbr_rows(r, nbr_out_loc, axis, xg, "out", col=inslot_loc, lanes=lanes)
    dd = _nbr_rows(d, nbr_out_loc, axis, xg, "out", col=inslot_loc, lanes=lanes)
    hit = (dd[None] == dv._bucket_iota(lo, hi, dd.ndim, dev)).to(_I32)
    return (hit * rv[None]).sum(-1, dtype=_I32)


def reply_counts_by_target_kreg(wire, target, nbr_out_loc, ids, axis=None,
                                xg=None):
    """Per-target reply totals without the dense path's scatter-add: target
    c gathers ``wire`` over its out-neighbours and keeps the repliers whose
    ``target`` is c (a replier's target is one of its in-neighbours, so the
    out-gather covers every reply).  The Raft stat vote router.  [N]."""
    lanes = wire.ndim > 1
    w = _nbr_rows(wire.to(_I32), nbr_out_loc, axis, xg, "out", lanes=lanes)
    tg = _nbr_rows(target, nbr_out_loc, axis, xg, "out", lanes=lanes)
    return (w * (tg == ids[:, None])).sum(-1, dtype=_I32)


# ------------------------------------------------ stat (gathered counts) ----


def bcast_counts_stat_kreg(key, send, nbr_in_loc, ids, probs: np.ndarray,
                           drop=0.0, axis=None, mode="exact", xg=None):
    """Stat twin of ``bcast_counts_stat`` over the overlay: receiver j hears
    from its active in-neighbours (a gathered count), spread multinomially
    over the buckets.  At k = N-1 the count equals ``n_senders -
    is_sender``.  [B, N]."""
    k = dv._shard_key(key, axis)
    m = in_counts(send, nbr_in_loc, ids, axis, xg)
    with dv.draw_rows(axis, -1):
        if drop > 0.0:
            m = dv._thinned(threefry.fold_in(k, 0x0D10), m, 1.0 - drop, mode)
        return sample_bucket_counts(k, m, probs, mode)


def push_bcast_slots_stat_kreg(key, slot_mat, nbr_in_loc, ids, probs: np.ndarray,
                               drop=0.0, axis=None, mode="exact", xg=None):
    """The contribution the JAX ``push_bcast_slots_stat_kreg`` adds to its
    ring: per-(receiver, slot) sender counts from an in-neighbour
    gather-sum, then the stat chain on the same key.  [B, N, S]."""
    k = dv._shard_key(key, axis)
    vals = _nbr_rows(slot_mat.to(_I32), nbr_in_loc, axis, xg,
                     lanes=slot_mat.ndim > 2)                        # [N, K, S]
    m = (vals * _notself(nbr_in_loc, ids)[:, :, None]).sum(-2, dtype=_I32)
    with dv.draw_rows(axis, -2):
        if drop > 0.0:
            m = dv._thinned(threefry.fold_in(k, 0x0D12), m, 1.0 - drop, mode)
        return dv.push_bucket_counts(k, m, probs, mode)


def bcast_value_max_stat_kreg(key, value, nbr_in_loc, probs: np.ndarray,
                              drop=0.0, axis=None, xg=None):
    """Stat twin of ``bcast_value_max_stat`` over the overlay: each receiver
    gets the max value announced in its in-neighbourhood (self included,
    as the dense global max re-delivers to the announcer harmlessly) with
    one delay draw a receiver.  [B, N]."""
    k = dv._shard_key(key, axis)
    dev = value.device
    n_loc = value.shape[-1]
    vmax = _nbr_rows(value.to(_I32), nbr_in_loc, axis, xg, lanes=value.ndim > 1).amax(-1)
    nb = len(probs)
    with dv.draw_rows(axis, -2):  # the noise is [N, B]
        d = threefry.categorical(k, dv._delay_logits(probs, dev), (n_loc,), dev)
    sent = (vmax > 0).to(_I32)
    if drop > 0.0:
        with dv.draw_rows(axis, -1):
            keep = threefry.bernoulli(threefry.fold_in(k, 0x0D13), 1.0 - drop, (n_loc,),
                                      dev)
        sent = sent * keep.to(_I32)
    return (d[None] == dv._bucket_iota(0, nb, d.ndim, dev)).to(_I32) * (sent * vmax)[None]


def bcast_window_value_max_stat_kreg(key, value_mat, nbr_in_loc,
                                     probs: np.ndarray, drop=0.0, axis=None,
                                     xg=None):
    """Stat twin of ``bcast_window_value_max_stat`` over the overlay:
    per-(receiver, window) in-neighbourhood max, one delay draw each; a
    receiver whose own announcement is the neighbourhood max is the sender
    and gets nothing.  [B, N, W]."""
    k = dv._shard_key(key, axis)
    vm = value_mat.to(_I32)
    dev = vm.device
    n_loc, w = vm.shape[-2:]
    vmax = _nbr_rows(vm, nbr_in_loc, axis, xg, lanes=vm.ndim > 2).amax(-2)  # [N, W]
    nb = len(probs)
    with dv.draw_rows(axis, -3):  # the noise is [N, W, B]
        d = threefry.categorical(k, dv._delay_logits(probs, dev), (n_loc, w), dev)
    recv = (vmax > 0) & (vm < vmax)
    if drop > 0.0:
        with dv.draw_rows(axis, -2):
            recv = recv & threefry.bernoulli(threefry.fold_in(k, 0x0D14), 1.0 - drop,
                                             (n_loc, w), dev)
    val = recv.to(_I32) * vmax
    return (d[None] == dv._bucket_iota(0, nb, d.ndim, dev)).to(_I32) * val[None]
