"""The node mesh (port of ``blockchain_simulator_tpu/parallel/mesh.py``).

The JAX package shards the node axis of every state and ring tensor over a
``jax.sharding.Mesh`` and lets XLA insert the collectives.  PyTorch runs
one process a rank under ``torch.distributed`` instead (NCCL on the card,
gloo on the CPU), so the port's mesh is a small object: the group of the
``nodes`` axis, this process's rank in it, the group's size and the device
the rank computes on.  Its methods are the collectives the sharded models
call, each the counterpart of a JAX one:

========================  ==================================
JAX                       :class:`NodeMesh`
========================  ==================================
``lax.psum``              :meth:`NodeMesh.psum` (all_reduce SUM)
``lax.pmax`` / ``pmin``   :meth:`NodeMesh.pmax` / ``pmin``
``all_gather(tiled)``     :meth:`NodeMesh.all_gather`
``all_to_all``            :meth:`NodeMesh.all_to_all`
``lax.axis_index``        :attr:`NodeMesh.rank`
========================  ==================================

The models name the axis as the JAX package's do (``cfg.mesh_axis =
"nodes"``); :meth:`NodeMesh.bind` makes a mesh the one that name resolves
to (:func:`bound`) while a sharded body runs (parallel/partition.py).  A
mesh made in an initialized process group issues every collective through
it, a group of one rank included (a NCCL world of size 1 runs NCCL); a mesh
of one rank without a group has identity collectives.  Either folds rank 0
into the per-shard keys, as a 1-device JAX mesh does.

The ``sweep`` axis (whole simulations batched over ranks) is the next
slice of the port: ``n_sweep`` > 1 raises naming it.
"""

from __future__ import annotations

import contextlib

import torch

NODES_AXIS = "nodes"
SWEEP_AXIS = "sweep"

# where the sweep axis and the surfaces built on it stand in ROADMAP.md
SWEEP_AXIS_ITEM = "the sweep axis of the port (ROADMAP.md queue A item 7)"

_BOUND: dict = {}


class NodeMesh:
    """The ``nodes`` axis of a run: ``size`` ranks of ``group`` (``None``
    for a one-rank mesh without a process group), this process's
    ``rank``, and its ``device``.  ``counts`` tallies the collectives
    issued through the group, by kind."""

    def __init__(self, size: int, rank: int, group, device):
        self.size = int(size)
        self.rank = int(rank)
        self.group = group
        self.device = torch.device(device)
        self.counts = {"all_reduce": 0, "all_gather": 0, "all_to_all": 0}
        # global view (global_view): the node axis has n_glob rows in
        # blocks of ceil(n_glob / size), the last block possibly shorter
        self.n_glob = None

    def global_view(self, n_glob: int) -> "NodeMesh":
        """This mesh's ranks and group in global view: the draws of a
        sharded body are each rank's rows of the single-device program's
        (no rank folded into the keys), and ``n_glob`` need not divide by
        the size (the sharded overlay, parallel/sweep.sharded_topo_sim_fn)."""
        m = NodeMesh(self.size, self.rank, self.group, self.device)
        m.counts = self.counts
        m.n_glob = int(n_glob)
        return m

    def block(self, n_glob: int) -> int:
        """Rows of a full block of an ``n_glob``-row axis."""
        return -(-int(n_glob) // self.size)

    def rows(self, n_glob: int) -> tuple:
        """``(first row, row count)`` of this rank's block."""
        b = self.block(n_glob)
        start = min(self.rank * b, int(n_glob))
        return start, min(b, int(n_glob) - start)

    def row_base(self, n_loc: int) -> int:
        """The global index of this rank's first row, given its row count."""
        if self.n_glob is not None:
            return self.rows(self.n_glob)[0]
        return self.rank * int(n_loc)

    # ---- the JAX mesh surface the partition layer reads ------------------
    @property
    def shape(self) -> dict:
        return {SWEEP_AXIS: 1, NODES_AXIS: self.size}

    def __repr__(self) -> str:
        return (f"NodeMesh(nodes={self.size}, rank={self.rank}, "
                f"device={self.device})")

    def reset_counts(self) -> None:
        for k in self.counts:
            self.counts[k] = 0

    # ---- collectives -----------------------------------------------------
    def _reduce(self, x, op):
        import torch.distributed as dist

        x = torch.as_tensor(x, device=self.device)
        if self.group is None:
            return x
        self.counts["all_reduce"] += 1
        dtype = x.dtype
        # gloo and NCCL reduce no bool: a bool reduces as int32 (MAX = any)
        buf = (x.to(torch.int32) if dtype == torch.bool else x).reshape(-1).clone()
        dist.all_reduce(buf, op=op, group=self.group)
        return buf.reshape(x.shape).to(dtype)

    def psum(self, x):
        """``lax.psum``: the sum over the ranks, on every rank."""
        import torch.distributed as dist

        return self._reduce(x, dist.ReduceOp.SUM)

    def pmax(self, x):
        """``lax.pmax``: the elementwise max over the ranks."""
        import torch.distributed as dist

        return self._reduce(x, dist.ReduceOp.MAX)

    def pmin(self, x):
        """``lax.pmin``: the elementwise min over the ranks."""
        import torch.distributed as dist

        return self._reduce(x, dist.ReduceOp.MIN)

    def all_gather(self, x, dim: int = 0):
        """``lax.all_gather(x, tiled=True)``: the ranks' blocks of ``x``
        concatenated along ``dim`` in rank order."""
        import torch.distributed as dist

        if self.group is None:
            return x
        self.counts["all_gather"] += 1
        dtype = x.dtype
        src = x.movedim(dim, 0)
        src = (src.to(torch.int32) if dtype == torch.bool else src).contiguous()
        if self.n_glob is not None:  # uneven blocks ride padded to a full one
            pad = self.block(self.n_glob) - src.shape[0]
            if pad:
                src = torch.cat([src, src.new_zeros((pad,) + src.shape[1:])])
        parts = [torch.empty_like(src) for _ in range(self.size)]
        # the list form exists on every torch this port meets (the tensor
        # form is deprecated in newer releases, absent as all_gather_single
        # in older ones)
        dist.all_gather(parts, src, group=self.group)
        out = torch.cat(parts, 0)
        if self.n_glob is not None:
            out = out[:self.n_glob]
        return out.to(dtype).movedim(0, dim)

    def all_to_all(self, x):
        """``lax.all_to_all(x, split_axis=0, concat_axis=0)``: block ``d`` of
        ``x``'s leading axis goes to rank ``d``, and the result stacks the
        blocks received from every rank in rank order."""
        import torch.distributed as dist

        if self.group is None:
            return x
        self.counts["all_to_all"] += 1
        src = x.contiguous()
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=self.group)
        return out

    def agree(self, pred) -> bool:
        """A gate's predicate read on the host after a MAX all-reduce, so
        that every rank takes the same branch (JAX pmax-reduces a gate's
        predicate before its ``lax.cond``)."""
        return bool(self.pmax(torch.as_tensor(pred, device=self.device)
                              .to(torch.int32)).item())

    @contextlib.contextmanager
    def bind(self, axis: str = NODES_AXIS):
        """Make this mesh the one ``axis`` names while the block runs."""
        prev = _BOUND.get(axis)
        _BOUND[axis] = self
        try:
            yield self
        finally:
            if prev is None:
                _BOUND.pop(axis, None)
            else:
                _BOUND[axis] = prev


def bound(axis: str) -> NodeMesh:
    """The mesh ``axis`` names (raises outside a sharded body)."""
    try:
        return _BOUND[axis]
    except KeyError:
        raise RuntimeError(
            f"mesh axis {axis!r} is not bound: a config with mesh_axis set "
            "runs inside parallel/partition.partition (parallel/shard.py)"
        ) from None


def make_mesh(n_node_shards: int | None = None, n_sweep: int = 1, devices=None,
              device=None) -> NodeMesh:
    """The ``nodes`` mesh of this process: every rank of the initialized
    default process group (``n_node_shards`` must then be its size, or
    None), or without a group a mesh of one rank (``n_node_shards`` 1 or
    None) on ``device`` (the card by default).  Rank r of a NCCL group
    computes on ``cuda:r``, as parallel/multihost.py sets it up.
    ``devices`` is JAX's device list: here only its length counts, as the
    number of node shards.  ``n_sweep`` > 1 raises: the sweep axis is the
    next slice."""
    import torch.distributed as dist

    if n_sweep != 1:
        raise NotImplementedError(
            f"n_sweep={n_sweep}: a mesh with a sweep axis comes with "
            f"{SWEEP_AXIS_ITEM}")
    if devices is not None and n_node_shards is None:
        n_node_shards = len(devices)
    if dist.is_available() and dist.is_initialized():
        size, rank = dist.get_world_size(), dist.get_rank()
        if n_node_shards is not None and n_node_shards != size:
            raise ValueError(
                f"mesh 1x{n_node_shards} needs {n_node_shards} ranks; the "
                f"process group has {size} (one rank a node shard)")
        if dist.get_backend() == "nccl":
            dev = torch.device("cuda", torch.cuda.current_device())
        else:
            dev = torch.device("cpu" if device is None else device)
        return NodeMesh(size, rank, dist.group.WORLD, dev)
    if n_node_shards not in (None, 1):
        raise ValueError(
            f"mesh 1x{n_node_shards} needs {n_node_shards} ranks, only 1 "
            "available: start the ranks with parallel/multihost.launch "
            "(or join a group with init_multihost)")
    if device is None:
        from blockchain_simulator_tpu_torch.runner import resolve_device

        device = resolve_device(None)
    return NodeMesh(1, 0, None, device)
