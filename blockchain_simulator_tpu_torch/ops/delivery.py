"""Message delivery: senders → per-bucket ring contributions.

Port of ``blockchain_simulator_tpu/ops/delivery.py``: each function turns
"who is sending what this tick" into a contribution tensor ``[B, ...receiver
dims]`` to be ring-pushed, where ``B`` spans the delay distribution's support
(offset ``lo``).  The *dense* functions draw one delay per edge; the *stat*
functions draw per-receiver bucket counts (ops/delay.py) without
materialising edges.  Every output is bit-equal to the JAX function on the
same key.

Senders never deliver to themselves; ``send`` masks are already fault-masked
by the caller; ``drop_prob`` models lossy edges.

SPMD: every function takes ``axis``, the name of the mesh axis the node
dimension is sharded over (None: unsharded).  Sharded, the receiver rows
stay local while sender-side quantities are globalized with the bound
mesh's collectives (parallel/mesh.py: all_gather for masks and values,
all_reduce SUM / MAX for totals), and every draw uses the shard's key (the
rank folded in), at the shard's shape: the JAX function inside
``shard_map``, bit for bit.

The JAX package's ``push_*`` functions sample and combine each bucket straight
into its ring slice; here they return the stacked contribution instead, which
the caller hands to the tick's one grouped ring push (ops/ring.py).  That is
what the JAX functions themselves do when its ring kernel is armed.

*Lane keys* (the tick engines' lanes, models/base.py): given a stack of
keys ``[L, 2]`` and sender tensors with a leading lane axis ``[L, N, ...]``,
a function returns ``[B, L, ...]``, lane ``l`` what ``jax.vmap`` (or
``lax.map``) of the JAX function gives it (ops/delay.py says how each
stream batches, and its ``lane_rule`` which rule applies).  Reductions run
over the trailing node axes, so one code serves both forms.  The lane
forms run unsharded.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

from blockchain_simulator_tpu_torch.ops.delay import (
    binom,
    sample_bucket_counts,
    sample_edge_delays,
)
from blockchain_simulator_tpu_torch.utils import threefry, xla_math

_I32 = torch.int32


def mesh_of(axis):
    """The mesh ``axis`` names (parallel/mesh.bound)."""
    from blockchain_simulator_tpu_torch.parallel.mesh import bound

    return bound(axis)


def _shard_key(key, axis):
    """Decorrelate per-shard sampling: each edge is drawn once, by the
    shard that consumes it (unsharded, or a mesh in global view: the key
    itself)."""
    if axis is None:
        return key
    mesh = mesh_of(axis)
    return key if mesh.n_glob is not None else threefry.fold_in(key, mesh.rank)


def draw_rows(axis, dim: int = -1):
    """The context a node-row draw runs in: on a mesh in global view
    (parallel/mesh.NodeMesh.global_view), the draw's ``dim`` (counted from
    the end) is this rank's block of the global node axis, and the rank
    draws exactly those rows of the single-device draw
    (utils/threefry.row_view); otherwise nothing changes."""
    if axis is None or mesh_of(axis).n_glob is None:
        return contextlib.nullcontext()
    mesh = mesh_of(axis)
    return threefry.row_view(dim, mesh.rows(mesh.n_glob)[0], mesh.n_glob)


def _gather(x, axis):
    """Local ``[n_loc, ...]`` -> global ``[N, ...]`` along the node axis."""
    return x if axis is None else mesh_of(axis).all_gather(x)


def _psum(x, axis):
    return x if axis is None else mesh_of(axis).psum(x)


def _pmax(x, axis):
    return x if axis is None else mesh_of(axis).pmax(x)


def _pmin(x, axis):
    return x if axis is None else mesh_of(axis).pmin(x)


def agree(pred, axis) -> bool:
    """A host-read gate predicate, agreed over the mesh (MAX) when sharded,
    so that every rank takes the same branch."""
    return bool(pred) if axis is None else mesh_of(axis).agree(pred)


def _rank_rows(x, n_loc: int, axis, dim: int = -1):
    """This shard's block of a global node axis ``dim`` (unsharded: ``x``)."""
    if axis is None:
        return x
    return x.narrow(dim, mesh_of(axis).row_base(n_loc), n_loc)


def _global_ids(n_loc: int, axis, device):
    """Global node ids of this shard's rows (unsharded: ``arange(n)``),
    made once per (rows, device): callers only read them."""
    base = 0 if axis is None else mesh_of(axis).row_base(n_loc)
    return row_ids(int(n_loc), base, torch.device(device))


@functools.lru_cache(maxsize=16)
def row_ids(n: int, base: int, device) -> torch.Tensor:
    """Node ids ``base .. base + n - 1`` (int32) on ``device``, made once."""
    return torch.arange(base, base + n, dtype=_I32, device=device)


def _bucket_iota(lo: int, hi: int, ndim: int, device):
    """``[B, 1, ...]`` bucket values ``lo..hi-1`` broadcastable against a
    rank-``ndim`` delay tensor."""
    return torch.arange(lo, hi, dtype=_I32, device=device).reshape(
        (-1,) + (1,) * ndim)


def _edge_hits(key, send, lo: int, hi: int, drop_prob: float = 0.0, axis=None,
               send_global=None, impl: str = "threefry"):
    """[B, N_send_global, N_recv_local] 0/1 int32 delivery indicators,
    self-edges removed.  Delays are drawn receiver-side (each edge's delay
    is consumed by one shard).  ``send_global`` lets callers reuse an
    already-gathered sender mask; ``impl`` selects the per-edge bit
    source."""
    dev = send.device
    n_loc = send.shape[-1]
    send_g = _gather(send, axis) if send_global is None else send_global
    n_glob = send_g.shape[-1]
    k = _shard_key(key, axis)
    with draw_rows(axis, -1):
        d = sample_edge_delays(k, (n_glob, n_loc), lo, hi, dev, impl)
    notself = (torch.arange(n_glob, device=dev)[:, None]
               != _global_ids(n_loc, axis, dev)[None, :])
    mask = send_g.to(_I32)[..., :, None] * notself.to(_I32)
    if drop_prob > 0.0:
        with draw_rows(axis, -1):
            keep = threefry.bernoulli(threefry.fold_in(k, 0x0D0D),
                                      1.0 - drop_prob, (n_glob, n_loc), dev)
        mask = mask * keep.to(_I32)
    return (d[None] == _bucket_iota(lo, hi, d.ndim, dev)).to(_I32) * mask[None]


def bcast_counts_dense(key, send, lo, hi, drop_prob=0.0, axis=None,
                       impl="threefry"):
    """Broadcast → per-receiver arrival counts.  Returns [B, N]."""
    return _edge_hits(key, send, lo, hi, drop_prob, axis, impl=impl).sum(-2, dtype=_I32)


def bcast_value_max_dense(key, send, value, lo, hi, drop_prob=0.0, axis=None,
                          impl="threefry"):
    """Broadcast of a per-sender value (>0; 0 = empty), max-combined at the
    receiver.  Returns [B, N]."""
    hits = _edge_hits(key, send, lo, hi, drop_prob, axis, impl=impl)
    return (hits * _gather(value, axis).to(_I32)[None, ..., None]).amax(-2)


def bcast_slots_dense(key, slot_mat, lo, hi, drop_prob=0.0, axis=None,
                      impl="threefry"):
    """Slot-keyed broadcast: sender i broadcasts ``slot_mat[i, s]`` copies per
    slot.  Returns arrival counts per (receiver, slot): [B, N, S].

    The JAX package computes ``einsum("bij,is->bjs")`` on int32.  CUDA
    matmul has no int32 kernel, so the product runs in float64 and converts
    back.  That is exact: every operand and partial sum is an integer below
    2**31 (a count is at most n * byz_copies), and float64 holds integers
    exactly to 2**53.  TF32 applies to float32 only, so no process-wide
    matmul flag matters here."""
    slot_g = _gather(slot_mat.to(_I32), axis)
    send = slot_mat.amax(-1) > 0
    hits = _edge_hits(key, send, lo, hi, drop_prob, axis,
                      send_global=slot_g.amax(-1) > 0,
                      impl=impl)  # [B, N_send_global, N_recv] 0/1
    prod = torch.matmul(hits.transpose(-1, -2).to(torch.float64),
                        slot_g.to(torch.float64))
    return prod.to(_I32)


def bcast_window_value_max_dense(key, value_mat, lo, hi, drop_prob=0.0, axis=None,
                                 impl="threefry"):
    """Per-window value broadcast (PBFT PRE_PREPARE carrying the slot id):
    sender i announces ``value_mat[i, w]`` (>0; 0 = empty) for window w; the
    receiver max-combines per window.  Returns [B, N, W].

    The JAX form materialises ``[B, N, N, W]`` (768 MB of int32 at n = 1000,
    W = 64); this reduces one window at a time over ``[B, N, N]`` instead —
    the same max."""
    vm = _gather(value_mat.to(_I32), axis)  # [N_send_global, W]
    send = value_mat.amax(-1) > 0
    hits = _edge_hits(key, send, lo, hi, drop_prob, axis, send_global=vm.amax(-1) > 0,
                      impl=impl)  # [B, N_send_global, N_recv] 0/1
    out = torch.empty(hits.shape[:-2] + hits.shape[-1:] + vm.shape[-1:], dtype=_I32,
                      device=vm.device)
    for wi in range(vm.shape[-1]):
        out[..., wi] = (hits * vm[None, ..., wi, None]).amax(-2)
    return out


def roundtrip_reply_counts_dense(key, send, lo, hi, drop_prob=0.0, peer_mask=None,
                                 axis=None, impl="threefry"):
    """Short-circuited request/reply round trip: sender i broadcasts, every
    peer (``peer_mask``) replies at once, the reply travels back with an
    independent delay.  Returns reply counts at the original sender:
    [B2, N], offset 2*lo, B2 = 2*(hi-lo)-1.  Sharded, the sender consumes
    both legs' delays, so they are drawn sender-side over the gathered peer
    axis."""
    dev = send.device
    n_loc = send.shape[-1]
    peers = (torch.ones((n_loc,), dtype=torch.bool, device=dev) if peer_mask is None
             else peer_mask)
    peers_g = _gather(peers, axis)
    n_glob = peers_g.shape[-1]
    k = _shard_key(key, axis)
    with draw_rows(axis, -2):
        d1 = sample_edge_delays(threefry.fold_in(k, 1), (n_loc, n_glob), lo, hi, dev, impl)
        d2 = sample_edge_delays(threefry.fold_in(k, 2), (n_loc, n_glob), lo, hi, dev, impl)
    total = d1 + d2  # delay until the reply reaches the sender
    notself = (_global_ids(n_loc, axis, dev)[:, None]
               != torch.arange(n_glob, device=dev)[None, :])
    mask = (send.to(_I32)[..., :, None] * notself.to(_I32)
            * peers_g.to(_I32)[..., None, :])
    if drop_prob > 0.0:
        # either leg can drop
        with draw_rows(axis, -2):
            keep = threefry.bernoulli(threefry.fold_in(k, 0x0D0E),
                                      (1.0 - drop_prob) ** 2, (n_loc, n_glob), dev)
        mask = mask * keep.to(_I32)
    lo2 = 2 * lo
    nb = 2 * (hi - lo) - 1
    hit = (total[None] == _bucket_iota(lo2, lo2 + nb, total.ndim, dev)).to(_I32)
    return (hit * mask[None]).sum(-1, dtype=_I32)


def unicast_reply_counts_dense(key, reply, lo, hi, drop_prob=0.0, axis=None,
                               impl="threefry"):
    """Route per-(replier, requester) reply counts back to each requester:
    ``reply[r, c]`` replies travel from node r to node c, one delay per
    edge.  Returns [B, N] indexed by requester.  An integer product over the
    ``[B, N, N]`` bucket mask, summed: exact.  Sharded, the repliers'
    contributions are summed over the shards (all_reduce) and each shard
    keeps its requesters' columns."""
    dev = reply.device
    n_loc, n_glob = reply.shape[-2:]
    k = _shard_key(key, axis)
    with draw_rows(axis, -2):
        d = sample_edge_delays(k, (n_loc, n_glob), lo, hi, dev, impl)
    notself = (_global_ids(n_loc, axis, dev)[:, None]
               != torch.arange(n_glob, device=dev)[None, :])
    mask = notself.to(_I32)
    if drop_prob > 0.0:
        with draw_rows(axis, -2):
            keep = threefry.bernoulli(threefry.fold_in(k, 0x0D0F), 1.0 - drop_prob,
                                      (n_loc, n_glob), dev)
        mask = mask * keep.to(_I32)
    r = reply.to(_I32) * mask
    hit = (d[None] == _bucket_iota(lo, hi, d.ndim, dev)).to(_I32)
    out_g = (r[None] * hit).sum(-2, dtype=_I32)  # [B, N_glob]
    if axis is None:
        return out_g
    return _rank_rows(_psum(out_g, axis), n_loc, axis).contiguous()


def bcast_matrix_dense(key, send, value, lo, hi, drop_prob=0.0, axis=None,
                       impl="threefry"):
    """Identity-preserving broadcast for request channels whose handling
    depends on receiver state at arrival (Raft VOTE_REQ): ``value`` (>0 per
    sender; 0 = empty) lands at ``[b, receiver, sender]``.  Returns [B, N, N],
    contiguous (the JAX function's ``swapaxes`` view, materialised once, as
    the ring push takes contiguous contributions)."""
    hits = _edge_hits(key, send, lo, hi, drop_prob, axis, impl=impl)  # [B, send, recv]
    value_g = _gather(value, axis)
    return (hits * value_g.to(_I32)[None, ..., None]).transpose(-1, -2).contiguous()


# --------------------------------------------------------------------------- #
# stat (aggregated, statistically exact) delivery                             #
# --------------------------------------------------------------------------- #


def _thinned(key, m, p_keep: float, mode: str):
    """Drop thinning of per-receiver message counts: ``round(Binomial(m,
    p_keep))`` as int32."""
    return torch.round(binom(key, m, p_keep, mode)).to(_I32)


def bcast_counts_stat(key, n_senders, is_sender, probs: np.ndarray, drop_prob=0.0,
                      axis=None, mode="exact"):
    """Full-mesh broadcast arrival counts: receiver j hears ``n_senders -
    is_sender[j]`` peers, spread multinomially over the delay buckets.
    Returns [B, N].  With lane keys, ``n_senders`` is ``[S, 1]``."""
    k = _shard_key(key, axis)
    m = torch.as_tensor(n_senders, dtype=_I32, device=is_sender.device) - is_sender.to(_I32)
    with draw_rows(axis, -1):
        if drop_prob > 0.0:
            m = _thinned(threefry.fold_in(k, 0x0D10), m, 1.0 - drop_prob, mode)
        return sample_bucket_counts(k, m, probs, mode)


def _slots_stat_m(key, slot_mat, drop_prob, axis, mode):
    """(shard key, per-(receiver, slot) sender counts) of the stat slot
    broadcast: totals over senders minus the receiver's own."""
    k = _shard_key(key, axis)
    sm = slot_mat.to(_I32)
    m = _psum(sm.sum(-2, dtype=_I32), axis)[..., None, :] - sm  # [N, S]
    if drop_prob > 0.0:
        with draw_rows(axis, -2):
            m = _thinned(threefry.fold_in(k, 0x0D12), m, 1.0 - drop_prob, mode)
    return k, m


def bcast_slots_stat(key, slot_mat, probs: np.ndarray, drop_prob=0.0, axis=None,
                     mode="exact"):
    """Stat version of bcast_slots_dense: multinomial arrival counts per
    (receiver, slot).  Returns [B, N, S]."""
    k, m = _slots_stat_m(key, slot_mat, drop_prob, axis, mode)
    with draw_rows(axis, -2):
        return sample_bucket_counts(k, m, probs, mode)


def _delay_logits(probs: np.ndarray, device):
    """``jnp.log(jnp.asarray(probs) + 1e-30)`` in float32."""
    p = torch.as_tensor(np.asarray(probs, np.float32), device=device) + 1e-30
    return xla_math.log(p)


def bcast_value_max_stat(key, value, probs: np.ndarray, drop_prob=0.0, axis=None):
    """Stat version of bcast_value_max_dense for a few senders (the PBFT
    VIEW_CHANGE): the max announced value reaches every receiver with one
    per-receiver categorical delay.  Returns [B, N]."""
    k = _shard_key(key, axis)
    dev = value.device
    n = value.shape[-1]
    vmax = _pmax(value.to(_I32).amax(-1, keepdim=True), axis)
    nb = len(probs)
    with draw_rows(axis, -2):  # the noise is [N, B]
        d = threefry.categorical(k, _delay_logits(probs, dev), (n,), dev)
    sent = (vmax > 0).to(_I32)
    if drop_prob > 0.0:
        with draw_rows(axis, -1):
            keep = threefry.bernoulli(threefry.fold_in(k, 0x0D13), 1.0 - drop_prob,
                                      (n,), dev)
        sent = sent * keep.to(_I32)
    return (d[None] == _bucket_iota(0, nb, d.ndim, dev)).to(_I32) * (sent * vmax)[None]


def bcast_window_value_max_stat(key, value_mat, probs: np.ndarray, drop_prob=0.0,
                                axis=None):
    """Stat version of bcast_window_value_max_dense for few senders per
    window (the PBFT leader): each window's max value reaches every
    receiver but its sender with one per-(receiver, window) categorical
    delay.  Returns [B, N, W]."""
    k = _shard_key(key, axis)
    vm = value_mat.to(_I32)
    dev = vm.device
    n, w = vm.shape[-2:]
    vmax = _pmax(vm.amax(-2), axis)[..., None, :]  # [1, W]
    nb = len(probs)
    with draw_rows(axis, -3):  # the noise is [N, W, B]
        d = threefry.categorical(k, _delay_logits(probs, dev), (n, w), dev)
    recv = (vmax > 0) & (vm < vmax)
    if drop_prob > 0.0:
        with draw_rows(axis, -2):
            keep = threefry.bernoulli(threefry.fold_in(k, 0x0D14), 1.0 - drop_prob,
                                      (n, w), dev)
        recv = recv & keep
    val = recv.to(_I32) * vmax
    return (d[None] == _bucket_iota(0, nb, d.ndim, dev)).to(_I32) * val[None]


def _roundtrip_stat_m(key, send, n_peers, drop_prob, axis, mode):
    """(shard key, per-sender reply counts) of the stat round trip; under
    drops both legs thin, ``(1 - p)**2``."""
    k = _shard_key(key, axis)
    m = send.to(_I32) * torch.as_tensor(n_peers, dtype=_I32, device=send.device)
    if drop_prob > 0.0:
        with draw_rows(axis, -1):
            m = _thinned(threefry.fold_in(k, 0x0D11), m, (1.0 - drop_prob) ** 2, mode)
    return k, m


def roundtrip_reply_counts_stat(key, send, n_peers, rt_probs: np.ndarray,
                                drop_prob=0.0, axis=None, mode="exact"):
    """Stat version of roundtrip_reply_counts_dense: each active sender gets
    ``n_peers`` replies spread over the round-trip distribution.  Returns
    [B2, N]."""
    k, m = _roundtrip_stat_m(key, send, n_peers, drop_prob, axis, mode)
    with draw_rows(axis, -1):
        return sample_bucket_counts(k, m, rt_probs, mode)


def push_bucket_counts(key, m, probs: np.ndarray, mode: str = "exact",
                       expand=None):
    """The ring contribution of ``Multinomial(m, probs)`` bucket counts:
    ``[B, ...]``, each bucket mapped through ``expand`` when given."""
    cnt = sample_bucket_counts(key, m, probs, mode)
    if expand is None:
        return cnt
    return torch.stack([expand(cnt[b]) for b in range(cnt.shape[0])])


def push_bcast_slots_stat(key, slot_mat, probs: np.ndarray, drop_prob=0.0,
                          axis=None, mode="exact"):
    """The contribution the JAX ``push_bcast_slots_stat`` adds to its ring
    (equal to :func:`bcast_slots_stat`)."""
    k, m = _slots_stat_m(key, slot_mat, drop_prob, axis, mode)
    with draw_rows(axis, -2):
        return push_bucket_counts(k, m, probs, mode)


def push_roundtrip_reply_counts_stat(key, send, n_peers, rt_probs: np.ndarray,
                                     drop_prob=0.0, axis=None, mode="exact",
                                     expand=None):
    """The contribution the JAX ``push_roundtrip_reply_counts_stat`` adds to
    its ring: the stat round-trip counts, each bucket through ``expand``."""
    k, m = _roundtrip_stat_m(key, send, n_peers, drop_prob, axis, mode)
    with draw_rows(axis, -1):
        return push_bucket_counts(k, m, rt_probs, mode, expand)


# --------------------------------------------------------------------------- #
# gossip flood forwarding (gossip topology)                                   #
# --------------------------------------------------------------------------- #


def gossip_fwd(key, fwd_vals, nbrs, n_glob: int, lo: int, hi: int, drop_prob=0.0,
               axis=None, fold=0x0D22, impl="threefry"):
    """TTL-flood forwarding: ``fwd_vals [N, P]`` (> 0: TTL-encoded values
    held by the rows; P is any per-value lane, Paxos proposers or PBFT
    windows) → ``[B, N, P]`` max-combined contributions at each sender's
    out-neighbours (``nbrs [N, deg]`` global ids), one delay draw per
    (sender, edge, lane).  The JAX function's scatter-max over the flat
    ``(bucket, receiver)`` index takes duplicate indices and self-loops;
    max is order-free, so one ``scatter_reduce_("amax")`` into zeros is
    bit-equal to it.  Sharded (``nbrs`` the shard's rows): each shard
    scatters its senders' forwards into the global row space, the shards'
    results are max-reduced, and each keeps its own rows.  Lane keys
    ``[L, 2]`` take ``fwd_vals [L, N, P]`` and give ``[B, L, N, P]``, each
    lane flooding over the same digraph."""
    k = _shard_key(key, axis)
    dev = fwd_vals.device
    n, p = fwd_vals.shape[-2:]
    lead = fwd_vals.shape[:-2]  # the lane axis, when there is one
    deg = nbrs.shape[1]
    d = sample_edge_delays(k, (n, deg, p), lo, hi, dev, impl)
    vals = fwd_vals.to(_I32)[..., :, None, :].expand(lead + (n, deg, p))
    if drop_prob > 0.0:
        keep = threefry.bernoulli(threefry.fold_in(k, fold), 1.0 - drop_prob,
                                  (n, deg, p), dev)
        vals = vals * keep.to(_I32)
    n_lanes = int(np.prod(lead, dtype=np.int64))
    cols = torch.arange(p, device=dev)
    lane = torch.arange(n_lanes, device=dev).reshape(lead + (1, 1, 1))
    flat_idx = ((((d - lo).to(torch.int64) * n_lanes + lane) * n_glob
                 + nbrs[:, :, None]) * p + cols)
    flat = torch.zeros(((hi - lo) * n_lanes * n_glob * p,), dtype=_I32, device=dev)
    flat.scatter_reduce_(0, flat_idx.reshape(-1), vals.reshape(-1), "amax",
                         include_self=True)
    out = flat.reshape((hi - lo,) + lead + (n_glob, p))
    if axis is None:
        return out
    return _rank_rows(_pmax(out, axis), n, axis, dim=1).contiguous()
