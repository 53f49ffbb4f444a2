"""Message delivery: senders → per-bucket ring contributions.

Port of ``blockchain_simulator_tpu/ops/delivery.py``: each function turns
"who is sending what this tick" into a contribution tensor ``[B, ...receiver
dims]`` to be ring-pushed, where ``B`` spans the delay distribution's support
(offset ``lo``).  The *dense* functions draw one delay per edge; the *stat*
functions draw per-receiver bucket counts (ops/delay.py) without
materialising edges.  Every output is bit-equal to the JAX function on the
same key.

Senders never deliver to themselves; ``send`` masks are already fault-masked
by the caller; ``drop_prob`` models lossy edges.  The JAX functions take a
mesh ``axis`` for sharded runs; the port is single-device in this slice and
raises on a non-None axis (sharding comes with the many-GPU slice).

The JAX package's ``push_*`` functions sample and combine each bucket straight
into its ring slice; here they return the stacked contribution instead, which
the caller hands to the tick's one grouped ring push (ops/ring.py).  That is
what the JAX functions themselves do when its ring kernel is armed.

*Lane keys* (the functions the Raft step draws with): given a stack of keys
``[S, 2]`` and sender tensors with a leading shard axis ``[S, N, ...]``, a
function returns ``[B, S, ...]``, shard ``s`` what ``jax.vmap`` of the JAX
function gives it (ops/delay.py says how each stream batches).  Reductions
run over the trailing node axes, so one code serves both forms.
"""

from __future__ import annotations

import numpy as np
import torch

from blockchain_simulator_tpu_torch.ops.delay import (
    binom,
    sample_bucket_counts,
    sample_edge_delays,
)
from blockchain_simulator_tpu_torch.utils import threefry, xla_math

_I32 = torch.int32


def _unsharded(axis):
    if axis is not None:
        raise NotImplementedError(
            f"sharded delivery (axis={axis!r}) comes with the many-GPU slice "
            "of the port; run unsharded (mesh_axis=None)"
        )


def _shard_key(key, axis):
    """The key a shard samples with (unsharded: the key itself)."""
    _unsharded(axis)
    return key


def _global_ids(n_loc: int, axis, device):
    """Global node ids of this shard's rows (unsharded: ``arange(n)``)."""
    _unsharded(axis)
    return torch.arange(n_loc, dtype=_I32, device=device)


def _bucket_iota(lo: int, hi: int, ndim: int, device):
    """``[B, 1, ...]`` bucket values ``lo..hi-1`` broadcastable against a
    rank-``ndim`` delay tensor."""
    return torch.arange(lo, hi, dtype=_I32, device=device).reshape(
        (-1,) + (1,) * ndim)


def _edge_hits(key, send, lo: int, hi: int, drop_prob: float = 0.0, axis=None,
               send_global=None, impl: str = "threefry"):
    """[B, N_send, N_recv] 0/1 int32 delivery indicators, self-edges
    removed.  ``send_global`` lets callers reuse an already-reduced sender
    mask; ``impl`` selects the per-edge bit source."""
    _unsharded(axis)
    dev = send.device
    n = send.shape[-1]
    send_g = send if send_global is None else send_global
    d = sample_edge_delays(key, (n, n), lo, hi, dev, impl)
    ids = torch.arange(n, device=dev)
    notself = ids[:, None] != ids[None, :]
    mask = send_g.to(_I32)[..., :, None] * notself.to(_I32)
    if drop_prob > 0.0:
        keep = threefry.bernoulli(threefry.fold_in(key, 0x0D0D),
                                  1.0 - drop_prob, (n, n), dev)
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
    return (hits * value.to(_I32)[None, ..., None]).amax(-2)


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
    slot_g = slot_mat.to(_I32)
    send = slot_g.amax(1) > 0
    hits = _edge_hits(key, send, lo, hi, drop_prob, axis, send_global=send,
                      impl=impl)  # [B, N_send, N_recv] 0/1
    prod = torch.matmul(hits.transpose(1, 2).to(torch.float64),
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
    vm = value_mat.to(_I32)  # [N_send, W]
    send = vm.amax(1) > 0
    hits = _edge_hits(key, send, lo, hi, drop_prob, axis, send_global=send,
                      impl=impl)  # [B, N_send, N_recv] 0/1
    b, n, w = hits.shape[0], hits.shape[2], vm.shape[1]
    out = torch.empty((b, n, w), dtype=_I32, device=vm.device)
    for wi in range(w):
        out[:, :, wi] = (hits * vm[None, :, wi, None]).amax(1)
    return out


def roundtrip_reply_counts_dense(key, send, lo, hi, drop_prob=0.0, peer_mask=None,
                                 axis=None, impl="threefry"):
    """Short-circuited request/reply round trip: sender i broadcasts, every
    peer (``peer_mask``) replies at once, the reply travels back with an
    independent delay.  Returns reply counts at the original sender:
    [B2, N], offset 2*lo, B2 = 2*(hi-lo)-1."""
    _unsharded(axis)
    dev = send.device
    n = send.shape[-1]
    peers = torch.ones((n,), dtype=torch.bool, device=dev) if peer_mask is None else peer_mask
    d1 = sample_edge_delays(threefry.fold_in(key, 1), (n, n), lo, hi, dev, impl)
    d2 = sample_edge_delays(threefry.fold_in(key, 2), (n, n), lo, hi, dev, impl)
    total = d1 + d2  # delay until the reply reaches the sender
    ids = torch.arange(n, device=dev)
    notself = ids[:, None] != ids[None, :]
    mask = (send.to(_I32)[..., :, None] * notself.to(_I32)
            * peers.to(_I32)[..., None, :])
    if drop_prob > 0.0:
        # either leg can drop
        keep = threefry.bernoulli(threefry.fold_in(key, 0x0D0E),
                                  (1.0 - drop_prob) ** 2, (n, n), dev)
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
    ``[B, N, N]`` bucket mask, summed: exact."""
    _unsharded(axis)
    dev = reply.device
    n_loc, n_glob = reply.shape[-2:]
    d = sample_edge_delays(key, (n_loc, n_glob), lo, hi, dev, impl)
    notself = torch.arange(n_loc, device=dev)[:, None] != torch.arange(n_glob, device=dev)[None, :]
    mask = notself.to(_I32)
    if drop_prob > 0.0:
        keep = threefry.bernoulli(threefry.fold_in(key, 0x0D0F), 1.0 - drop_prob,
                                  (n_loc, n_glob), dev)
        mask = mask * keep.to(_I32)
    r = reply.to(_I32) * mask
    hit = (d[None] == _bucket_iota(lo, hi, d.ndim, dev)).to(_I32)
    return (r[None] * hit).sum(-2, dtype=_I32)


def bcast_matrix_dense(key, send, value, lo, hi, drop_prob=0.0, axis=None,
                       impl="threefry"):
    """Identity-preserving broadcast for request channels whose handling
    depends on receiver state at arrival (Raft VOTE_REQ): ``value`` (>0 per
    sender; 0 = empty) lands at ``[b, receiver, sender]``.  Returns [B, N, N],
    contiguous (the JAX function's ``swapaxes`` view, materialised once, as
    the ring push takes contiguous contributions)."""
    hits = _edge_hits(key, send, lo, hi, drop_prob, axis, impl=impl)  # [B, send, recv]
    return (hits * value.to(_I32)[None, ..., None]).transpose(-1, -2).contiguous()


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
    if drop_prob > 0.0:
        m = _thinned(threefry.fold_in(k, 0x0D10), m, 1.0 - drop_prob, mode)
    return sample_bucket_counts(k, m, probs, mode)


def _slots_stat_m(key, slot_mat, drop_prob, axis, mode):
    """(shard key, per-(receiver, slot) sender counts) of the stat slot
    broadcast: totals over senders minus the receiver's own."""
    k = _shard_key(key, axis)
    sm = slot_mat.to(_I32)
    m = sm.sum(0, dtype=_I32)[None, :] - sm  # [N, S]
    if drop_prob > 0.0:
        m = _thinned(threefry.fold_in(k, 0x0D12), m, 1.0 - drop_prob, mode)
    return k, m


def bcast_slots_stat(key, slot_mat, probs: np.ndarray, drop_prob=0.0, axis=None,
                     mode="exact"):
    """Stat version of bcast_slots_dense: multinomial arrival counts per
    (receiver, slot).  Returns [B, N, S]."""
    k, m = _slots_stat_m(key, slot_mat, drop_prob, axis, mode)
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
    vmax = value.to(_I32).amax(-1, keepdim=True)
    nb = len(probs)
    d = threefry.categorical(k, _delay_logits(probs, dev), (n,), dev)
    sent = (vmax > 0).to(_I32)
    if drop_prob > 0.0:
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
    n, w = vm.shape
    vmax = vm.amax(0)  # [W]
    nb = len(probs)
    d = threefry.categorical(k, _delay_logits(probs, dev), (n, w), dev)
    recv = (vmax[None, :] > 0) & (vm < vmax[None, :])
    if drop_prob > 0.0:
        keep = threefry.bernoulli(threefry.fold_in(k, 0x0D14), 1.0 - drop_prob,
                                  (n, w), dev)
        recv = recv & keep
    val = recv.to(_I32) * vmax[None, :]
    return (d[None] == _bucket_iota(0, nb, d.ndim, dev)).to(_I32) * val[None]


def _roundtrip_stat_m(key, send, n_peers, drop_prob, axis, mode):
    """(shard key, per-sender reply counts) of the stat round trip; under
    drops both legs thin, ``(1 - p)**2``."""
    k = _shard_key(key, axis)
    m = send.to(_I32) * torch.as_tensor(n_peers, dtype=_I32, device=send.device)
    if drop_prob > 0.0:
        m = _thinned(threefry.fold_in(k, 0x0D11), m, (1.0 - drop_prob) ** 2, mode)
    return k, m


def roundtrip_reply_counts_stat(key, send, n_peers, rt_probs: np.ndarray,
                                drop_prob=0.0, axis=None, mode="exact"):
    """Stat version of roundtrip_reply_counts_dense: each active sender gets
    ``n_peers`` replies spread over the round-trip distribution.  Returns
    [B2, N]."""
    k, m = _roundtrip_stat_m(key, send, n_peers, drop_prob, axis, mode)
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
    return push_bucket_counts(k, m, probs, mode)


def push_roundtrip_reply_counts_stat(key, send, n_peers, rt_probs: np.ndarray,
                                     drop_prob=0.0, axis=None, mode="exact",
                                     expand=None):
    """The contribution the JAX ``push_roundtrip_reply_counts_stat`` adds to
    its ring: the stat round-trip counts, each bucket through ``expand``."""
    k, m = _roundtrip_stat_m(key, send, n_peers, drop_prob, axis, mode)
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
    bit-equal to it."""
    k = _shard_key(key, axis)
    dev = fwd_vals.device
    n, p = fwd_vals.shape
    deg = nbrs.shape[1]
    d = sample_edge_delays(k, (n, deg, p), lo, hi, dev, impl)
    vals = fwd_vals.to(_I32)[:, None, :].expand(n, deg, p)
    if drop_prob > 0.0:
        keep = threefry.bernoulli(threefry.fold_in(k, fold), 1.0 - drop_prob,
                                  (n, deg, p), dev)
        vals = vals * keep.to(_I32)
    lanes = torch.arange(p, device=dev)
    flat_idx = (((d - lo).to(torch.int64) * n_glob + nbrs[:, :, None]) * p
                + lanes[None, None, :])
    flat = torch.zeros(((hi - lo) * n_glob * p,), dtype=_I32, device=dev)
    flat.scatter_reduce_(0, flat_idx.reshape(-1), vals.reshape(-1), "amax",
                         include_self=True)
    return flat.reshape(hi - lo, n_glob, p)
