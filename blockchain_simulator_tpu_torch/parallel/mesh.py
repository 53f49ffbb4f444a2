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

The ``sweep`` axis batches whole simulations over ranks.  JAX's
``make_mesh(n_node_shards, n_sweep)`` reshapes its devices to ``(n_sweep,
n_nodes)``; here a world of ``n_sweep * n_nodes`` ranks is read the same
way: rank ``r`` sits at sweep row ``r // n_nodes`` and node column ``r %
n_nodes``.  Each row has a nodes group of its own (the group above), and
the grid one gloo group over all of its ranks (:attr:`NodeMesh.host_group`),
through which the sweeps exchange the host objects their callers read (the
metrics rows and the probe summaries, never the final states) together
with each rank's outcome, so that every rank of the grid acts on one
decision (:meth:`NodeMesh.exchange`).  Every rank creates every group in
the same order, as ``dist.new_group`` requires.
"""

from __future__ import annotations

import contextlib

import torch

NODES_AXIS = "nodes"
SWEEP_AXIS = "sweep"

# where the serving surfaces of the sweep axis (a server or a fleet whose
# batched flushes run over a sweep mesh) stand in ROADMAP.md
MESH_SERVING_ITEM = ("the serving surfaces of the sweep axis "
                     "(ROADMAP.md queue A item 7b)")

_BOUND: dict = {}
# the groups of a (n_sweep, n_nodes) grid of the current process group, made
# once a shape, and the collective counts of each mesh cell, shared by the
# meshes equal to it (multihost.shutdown forgets both with the group)
_GRIDS: dict = {}
_COUNTS: dict = {}
# the timeout the grid's groups get (parallel/multihost.init_multihost sets
# its group's; None is torch's default)
GROUP_TIMEOUT = None


class MeshPeerError(RuntimeError):
    """Another rank of the grid failed the step that this rank finished
    (:meth:`NodeMesh.exchange`): every rank treats the step as failed."""


class NodeMesh:
    """The ``nodes`` axis of a run: ``size`` ranks of ``group`` (``None``
    for a one-rank mesh without a process group), this process's
    ``rank``, and its ``device``.  ``counts`` tallies the collectives
    issued through the group, by kind: one dict for all the meshes equal
    to this one (a cached program built on an equal mesh counts here too).

    On a grid with a sweep axis, ``n_sweep`` rows of such groups: this
    rank's row ``sweep_index``.  ``host_group`` is the gloo group of the
    whole grid (``None`` on a grid of one rank)."""

    axis_names = (SWEEP_AXIS, NODES_AXIS)

    def __init__(self, size: int, rank: int, group, device, n_sweep: int = 1,
                 sweep_index: int = 0, host_group=None):
        self.size = int(size)
        self.rank = int(rank)
        self.group = group
        self.device = torch.device(device)
        self.n_sweep = int(n_sweep)
        self.sweep_index = int(sweep_index)
        self.host_group = host_group
        # global view (global_view): the node axis has n_glob rows in
        # blocks of ceil(n_glob / size), the last block possibly shorter
        self.n_glob = None
        fresh = {"all_reduce": 0, "all_gather": 0, "all_to_all": 0}
        # a mesh without a group counts nothing (its collectives are identities)
        self.counts = fresh if group is None else _COUNTS.setdefault(self._key(), fresh)

    def global_view(self, n_glob: int) -> "NodeMesh":
        """This mesh's ranks and group in global view: the draws of a
        sharded body are each rank's rows of the single-device program's
        (no rank folded into the keys), and ``n_glob`` need not divide by
        the size (the sharded overlay, parallel/sweep.sharded_topo_sim_fn)."""
        m = self.row()
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

    def row(self) -> "NodeMesh":
        """This rank's sweep row alone: the nodes mesh its lanes run on (its
        collectives counted with this mesh's)."""
        m = NodeMesh(self.size, self.rank, self.group, self.device)
        m.counts = self.counts
        return m

    def _key(self) -> tuple:
        return (self.n_sweep, self.size, self.sweep_index, self.rank, str(self.device),
                id(self.group), id(self.host_group), self.n_glob)

    # a mesh keys registry entries (utils/aotcache.py) by what it is, as a
    # JAX mesh does: two make_mesh calls of one shape give one entry
    def __eq__(self, other) -> bool:
        return isinstance(other, NodeMesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    @property
    def world_rank(self) -> int:
        """This rank's index in the ``(n_sweep, size)`` grid, row-major."""
        return self.sweep_index * self.size + self.rank

    def exchange(self, err, obj) -> list:
        """Every sweep row's ``obj``, in row order, on every rank, once every
        rank of the grid has reported how its step ended (``err``: the
        exception it raised, or ``None``).  One all_gather of host objects
        over the grid's gloo group; a row's ``obj`` is its first rank's.  If
        any rank failed, ``err`` is raised on that rank and
        :class:`MeshPeerError` on the others, so the grid retries, degrades
        or stops as one.  Call it in the thread that drives the grid, never
        in one that a deadline may abandon."""
        if self.host_group is None:
            if err is not None:
                raise err
            return [obj]
        import torch.distributed as dist

        out = [None] * (self.n_sweep * self.size)
        dist.all_gather_object(out, (None if err is None else f"{type(err).__name__}: {err}",
                                     None if err is not None else obj),
                               group=self.host_group)
        if err is not None:
            raise err
        failed = [(r, msg) for r, (msg, _) in enumerate(out) if msg is not None]
        if failed:
            raise MeshPeerError("; ".join(f"rank {r} of the grid failed: {msg}"
                                          for r, msg in failed))
        return [o for _, o in out[::self.size]]

    def from_rank0(self, obj):
        """The grid's rank 0's ``obj`` on every rank (a broadcast over the
        grid's gloo group): one value that every rank acts on."""
        if self.host_group is None:
            return obj
        import torch.distributed as dist

        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self.host_group)
        return box[0]

    # ---- the JAX mesh surface the partition layer reads ------------------
    @property
    def shape(self) -> dict:
        return {SWEEP_AXIS: self.n_sweep, NODES_AXIS: self.size}

    def __repr__(self) -> str:
        return (f"NodeMesh(sweep={self.n_sweep}, nodes={self.size}, "
                f"rank={self.world_rank}, device={self.device})")

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


def _grid_groups(n_sweep: int, n_nodes: int, world: int, backend: str) -> tuple:
    """``(nodes groups a row, the grid's gloo group)`` of a ``(n_sweep,
    n_nodes)`` grid over the world's ranks, made once a shape: the nodes
    groups on the world's backend (``None`` for rows of one rank; the world
    itself for one row), the host group gloo (the world itself where that
    is gloo).  Every rank makes every group, in the same order."""
    import torch.distributed as dist

    key = (n_sweep, n_nodes, world)
    if key not in _GRIDS:
        if n_sweep == 1:
            rows = [dist.group.WORLD]
        else:
            rows = [dist.new_group(list(range(i * n_nodes, (i + 1) * n_nodes)),
                                   backend=backend, timeout=GROUP_TIMEOUT)
                    if n_nodes > 1 else None for i in range(n_sweep)]
        host = dist.group.WORLD if backend == "gloo" else \
            dist.new_group(list(range(world)), backend="gloo", timeout=GROUP_TIMEOUT)
        _GRIDS[key] = (rows, host)
    return _GRIDS[key]


def make_mesh(n_node_shards: int | None = None, n_sweep: int = 1, devices=None,
              device=None) -> NodeMesh:
    """The ``(n_sweep, n_nodes)`` mesh of this process over every rank of
    the initialized default process group (``n_sweep * n_node_shards``
    ranks; ``n_node_shards`` None takes the group's size over ``n_sweep``),
    or without a group a mesh of one rank (both sizes 1 or None) on
    ``device`` (the card by default).  A rank of a NCCL group computes on
    the card parallel/multihost.py selected for it (rank r on ``cuda:(r %
    cards)``): the ranks of one nodes row need distinct cards, the rows may
    share them.  ``devices`` is JAX's device list: here only its length
    counts, as the grid's rank count."""
    import torch.distributed as dist

    n_sweep = int(n_sweep)
    if n_sweep < 1:
        raise ValueError(f"n_sweep must be >= 1, got {n_sweep}")
    if devices is not None and n_node_shards is None:
        if len(devices) % n_sweep:
            raise ValueError(f"{len(devices)} devices not divisible by n_sweep={n_sweep}")
        n_node_shards = len(devices) // n_sweep
    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        if n_node_shards is None:
            if world % n_sweep:
                raise ValueError(f"{world} ranks not divisible by n_sweep={n_sweep}")
            n_node_shards = world // n_sweep
        n_nodes = int(n_node_shards)
        if n_sweep * n_nodes != world:
            raise ValueError(
                f"mesh {n_sweep}x{n_nodes} needs {n_sweep * n_nodes} ranks; the "
                f"process group has {world} (one rank a mesh cell)")
        if dist.get_backend() == "nccl":
            dev = torch.device("cuda", torch.cuda.current_device())
            cards = torch.cuda.device_count()
            if n_nodes > cards:
                raise RuntimeError(
                    f"a nodes row of {n_nodes} NCCL ranks needs {n_nodes} cards; "
                    f"{cards} visible (no fallback to the CPU or to fewer ranks)")
        else:
            dev = torch.device("cpu" if device is None else device)
        if world == 1:
            return NodeMesh(1, 0, dist.group.WORLD, dev)
        rows, host = _grid_groups(n_sweep, n_nodes, world, dist.get_backend())
        i, j = divmod(rank, n_nodes)
        return NodeMesh(n_nodes, j, rows[i], dev, n_sweep=n_sweep, sweep_index=i,
                        host_group=host)
    if n_sweep != 1 or n_node_shards not in (None, 1):
        raise ValueError(
            f"mesh {n_sweep}x{n_node_shards} needs {n_sweep * (n_node_shards or 1)} ranks, "
            "only 1 available: start the ranks with parallel/multihost.launch "
            "(or join a group with init_multihost)")
    if device is None:
        from blockchain_simulator_tpu_torch.runner import resolve_device

        device = resolve_device(None)
    return NodeMesh(1, 0, None, device)
