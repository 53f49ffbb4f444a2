"""Partition rules: the one place meshes meet programs (port of
``blockchain_simulator_tpu/parallel/partition.py``).

The rule layer is the JAX package's: a declaration of ``(regex path
pattern, spec)`` rules turns into a spec for every leaf of a state or ring
tree (:func:`match_partition_rules`; the first ``re.search`` match on the
``/``-joined field path wins, scalar leaves never shard, a non-scalar leaf
that matches no rule raises).  A spec is a :class:`P`, the counterpart of
``jax.sharding.PartitionSpec``: ``P(NODES_AXIS)`` shards dim 0 over the
nodes axis, ``P(None, NODES_AXIS)`` dim 1, ``P()`` replicates.

:func:`partition` is the door.  JAX compiles one SPMD program over its
devices; here every rank of the group runs the same Python, so the door
takes the GLOBAL operands every rank holds and keeps this rank's block of
every sharded leaf (contiguous, so the ring kernel takes it), or takes
those blocks themselves (``scattered=True``: parallel/shard.py's ranks
build only their rows of the init, so no rank holds the global rings),
runs the body with the mesh bound to the nodes axis
(parallel/mesh.NodeMesh.bind), and all-gathers every sharded output, so
each rank returns the full result.  Its two styles are JAX's:

- ``in_specs`` / ``out_specs`` (shard_map, per-shard view): the node dims
  divide evenly, and the body's draws fold the rank into their keys
  (ops/delivery._shard_key) as shard_map bodies do.
- ``in_shardings`` / ``out_shardings`` (pjit, global view): the body's
  draws are each rank's rows of the single-device program's, and the node
  axis splits into blocks of ``ceil(n / ranks)`` (the last one shorter):
  the sharded overlay (parallel/sweep.sharded_topo_sim_fn), bit-equal to
  the single-device run.

:class:`NeighborExchange` and :class:`ExchangeSpec` are the overlay's
owner-bucketed neighbour reads: one ``all_to_all_single`` of the static
owner buckets a call (plans from topo/spec.owner_bucket_plan).  The sweep
helpers (:func:`pad_points`, :func:`align_chunk`) lay a sweep's lanes over
the sweep rows of a mesh (parallel/sweep.py), as JAX's do.
"""

from __future__ import annotations

import dataclasses
import re
import time

import numpy as np
import torch

from blockchain_simulator_tpu_torch.parallel.mesh import NODES_AXIS, SWEEP_AXIS
from blockchain_simulator_tpu_torch.utils.sync import force_sync

REPLICATED = None  # a rule spec of None means "replicate"


class P(tuple):
    """A partition spec: one entry a dim, a mesh axis name or ``None``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"

    def node_dim(self):
        """The dim sharded over the nodes axis, or ``None``."""
        return self.index(NODES_AXIS) if NODES_AXIS in self else None


def mesh_size(mesh) -> int:
    """Total rank count of a mesh."""
    return int(np.prod(list(mesh.shape.values())))


def mesh_shape_dict(mesh) -> dict:
    """``{axis name: size}`` of a mesh as plain JSON-able types."""
    return {str(k): int(v) for k, v in dict(mesh.shape).items()}


def mesh_tag(mesh) -> str:
    """Stable mesh descriptor (``"nodes4"``; ``"single"`` for one rank)."""
    parts = [f"{name}{size}" for name, size in mesh_shape_dict(mesh).items()
             if int(size) > 1]
    return "_".join(parts) if parts else "single"


def sweep_axis_size(mesh) -> int:
    """Size of the mesh's sweep axis (0 when the mesh has none)."""
    return int(dict(mesh.shape).get(SWEEP_AXIS, 0))


# ------------------------------------------------------------ trees --------


def path_name(path) -> str:
    """``/``-joined name of a tree path (field names, dict keys, indices)."""
    return "/".join(str(p) for p in path)


def tree_map_with_path(fn, tree, *rest, path=()):
    """``fn(path, leaf, *rest_leaves)`` over a tree of dataclasses, tuples,
    lists and dicts (anything else is a leaf), rebuilt in its structure."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map_with_path(fn, getattr(tree, f.name),
                                       *(getattr(r, f.name) for r in rest),
                                       path=path + (f.name,))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, (tuple, list)) and not isinstance(tree, P):
        out = [tree_map_with_path(fn, x, *(r[i] for r in rest), path=path + (i,))
               for i, x in enumerate(tree)]
        return type(tree)(out)
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest), path=path + (k,))
                for k, v in tree.items()}
    return fn(path, tree, *rest)


def match_partition_rules(rules, tree):
    """The :class:`P` tree for ``tree`` from ``((regex, spec), ...)``
    rules: the first rule whose pattern matches the leaf's ``/``-joined
    path wins; its spec (a :class:`P` or :data:`REPLICATED`) is padded with
    ``None`` to the leaf's rank.  Scalar (0-d or size-1) leaves never
    shard; a non-scalar leaf matching no rule raises."""
    compiled = [(re.compile(pat), spec) for pat, spec in rules]

    def spec_for(path, leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        ndim = len(shape)
        if ndim == 0 or int(np.prod(shape)) == 1:
            return P()
        name = path_name(path)
        for pat, spec in compiled:
            if pat.search(name) is None:
                continue
            entries = tuple(spec) if spec is not None else ()
            if len(entries) > ndim:
                raise ValueError(
                    f"partition rule {pat.pattern!r} spec {spec} has "
                    f"{len(entries)} entries for rank-{ndim} leaf {name!r}")
            return P(*entries, *([None] * (ndim - len(entries))))
        raise ValueError(f"no partition rule matched leaf {name!r} "
                         f"(shape {shape})")

    return tree_map_with_path(spec_for, tree)


def node_dim_rules(replicated_names=()):
    """Rules declaring: the named leaves replicate, every other non-scalar
    leaf shards dim 0 over the nodes axis."""
    rules = tuple((rf"(^|/){re.escape(name)}$", REPLICATED)
                  for name in replicated_names)
    return rules + ((r".*", P(NODES_AXIS)),)


def _block(mesh, length: int, even: bool) -> tuple:
    """``(start, rows)`` of this rank's block of a ``length``-row dim."""
    if even:
        if length % mesh.size:
            raise ValueError(f"a node dim of {length} rows does not divide into "
                             f"{mesh.size} shards")
        b = length // mesh.size
        return mesh.rank * b, b
    return mesh.rows(length)


def scatter(tree, specs, mesh, even: bool = True):
    """This rank's block of every sharded leaf of the global ``tree``
    (contiguous), every other leaf as it is."""
    def take(path, leaf, spec):
        dim = spec.node_dim() if isinstance(spec, P) else None
        if dim is None or not isinstance(leaf, torch.Tensor):
            return leaf
        start, rows = _block(mesh, leaf.shape[dim], even)
        return leaf.narrow(dim, start, rows).contiguous()

    return tree_map_with_path(take, tree, specs)


def gather(tree, specs, mesh):
    """Every sharded leaf of a rank-local ``tree`` all-gathered along its
    node dim (JAX's out_specs reassembling the global array)."""
    def put(path, leaf, spec):
        dim = spec.node_dim() if isinstance(spec, P) else None
        if dim is None or not isinstance(leaf, torch.Tensor):
            return leaf
        return mesh.all_gather(leaf, dim)

    return tree_map_with_path(put, tree, specs)


def partition(fn, mesh, *, in_shardings=None, out_shardings=None,
              in_specs=None, out_specs=None, wrap_jit=True):
    """Run ``fn`` over ``mesh`` — the one mesh-program door.  Exactly one
    style may be given: ``in_specs`` / ``out_specs`` (per-shard view) or
    ``in_shardings`` / ``out_shardings`` (global view; both required).
    The returned callable takes the global operands, runs ``fn`` on this
    rank's blocks with the mesh bound (in global view for the explicit
    shardings), and returns the gathered outputs; called with
    ``scattered=True`` it takes this rank's blocks themselves (a caller
    that built only its rows, as parallel/shard.py's inits do).  Given a
    ``timings`` dict, it syncs the device after the body and after the
    gather and records their seconds as ``body_s`` and ``gather_s``.
    ``wrap_jit`` is JAX's (whether the program is jitted); eager PyTorch
    has nothing to wrap."""
    del wrap_jit
    explicit = in_shardings is not None or out_shardings is not None
    mapped = in_specs is not None or out_specs is not None
    if explicit and mapped:
        raise ValueError(
            "partition() takes either explicit shardings (pjit) or "
            "per-shard specs (shard_map), not both")
    if explicit and (in_shardings is None or out_shardings is None):
        raise ValueError(
            "partition() requires both in_shardings and out_shardings "
            "when using explicit-sharding pjit; pass in_specs/out_specs "
            "for the shard_map fallback instead")
    if not explicit and not mapped:
        raise ValueError(
            "partition() needs in_shardings/out_shardings (pjit) or "
            "in_specs/out_specs (shard_map)")
    ins = in_shardings if explicit else in_specs
    outs = out_shardings if explicit else out_specs

    def run(*args, scattered=False, timings=None):
        if explicit:
            if scattered:
                raise ValueError("a global-view partition takes the global operands")
            n_glob = _node_rows(args, ins)
            bound_mesh = mesh.global_view(n_glob)
        else:
            bound_mesh = mesh
        local = (tuple(args) if scattered
                 else scatter(tuple(args), tuple(ins), bound_mesh, even=not explicit))
        t0 = time.perf_counter()
        with bound_mesh.bind(NODES_AXIS):
            out = fn(*local)
            if timings is not None:
                force_sync(out)
                t1 = time.perf_counter()
            out = gather(out, outs, bound_mesh)
        if timings is not None:
            force_sync(out)
            timings.update(body_s=t1 - t0, gather_s=time.perf_counter() - t1)
        return out

    return run


def _node_rows(args, specs) -> int:
    """The global node count of a global-view call: the first sharded
    operand's node dim."""
    found = []

    def look(path, leaf, spec):
        dim = spec.node_dim() if isinstance(spec, P) else None
        if dim is not None and hasattr(leaf, "shape"):
            found.append(int(leaf.shape[dim]))
        return leaf

    tree_map_with_path(look, tuple(args), tuple(specs))
    if not found:
        raise ValueError("a global-view partition needs a node-sharded operand")
    return found[0]


# ------------------------------------------- shard-local neighbour exchange --


class NeighborExchange:
    """Owner-bucketed cross-shard neighbour reads, the runtime half of
    ``topo.spec.owner_bucket_plan``.  ``xg(x, kind="in")`` is exactly the
    global gather ``x_global[table]`` of the kind's ``[N, K]`` table at this
    rank's rows, and ``xg(x, kind=..., col=c)`` exactly
    ``x_global.reshape(-1)[table * x.shape[1] + c]``, but the only
    communication is ONE ``all_to_all_single`` of the static ``[D, C, ...]``
    owner buckets a call: each rank ships the rows its peers read, and no
    tensor at global shape exists on any rank.  ``plans`` maps a kind to
    this rank's ``(pos [n_loc, K], send [1, D, C])`` rows of the plan.
    Must run with ``mesh`` bound (inside :func:`partition`)."""

    def __init__(self, mesh, n: int, plans: dict):
        if not plans:
            raise ValueError("NeighborExchange needs at least one plan")
        self.mesh = mesh
        self.n = int(n)
        self.plans = dict(plans)

    def __call__(self, x, kind: str = "in", col=None):
        from blockchain_simulator_tpu_torch.parallel.mesh import bound

        mesh = bound(NODES_AXIS)
        pos, send = self.plans[kind]
        d, c = int(send.shape[1]), int(send.shape[2])
        n_loc = x.shape[0]
        pos = pos[:n_loc]  # the plans cover the padded rows
        block = mesh.block(self.n)
        if n_loc < block:  # the short last block rides padded
            x = torch.cat([x, x.new_zeros((block - x.shape[0],) + x.shape[1:])])
        sb = x.index_select(0, send[0].reshape(-1).to(torch.int64))
        sb = sb.reshape((d, c) + x.shape[1:])                 # [D, C, ...]
        rb = mesh.all_to_all(sb)
        if col is None:
            flat = rb.reshape((d * c,) + rb.shape[2:])
            p = pos.to(torch.int64)
            return flat.index_select(0, p.reshape(-1)).reshape(p.shape + flat.shape[1:])
        w = int(x.shape[1])
        flat = rb.reshape(-1)
        idx = pos.to(torch.int64) * w + col.to(torch.int64)
        return flat.index_select(0, idx.reshape(-1)).reshape(idx.shape)


class ExchangeSpec:
    """Static description of the exchange-plan operand block a sharded
    kregular program appends after its table operands: ``(pos, send)`` a
    table kind, in ``kinds`` order (JAX's ``ExchangeSpec``)."""

    def __init__(self, mesh, n: int, kinds=("in", "out")):
        self.mesh = mesh
        self.n = int(n)
        self.kinds = tuple(kinds)

    @property
    def n_operands(self) -> int:
        return 2 * len(self.kinds)

    def build(self, *plan_operands) -> NeighborExchange:
        if len(plan_operands) != self.n_operands:
            raise ValueError(
                f"ExchangeSpec.build: expected {self.n_operands} plan "
                f"operands ({'/'.join(self.kinds)} pos+send), got "
                f"{len(plan_operands)}")
        plans = {k: (plan_operands[2 * i], plan_operands[2 * i + 1])
                 for i, k in enumerate(self.kinds)}
        return NeighborExchange(self.mesh, self.n, plans)


# ----------------------------------------------------- mesh-sweep helpers ---


def pad_points(points, lanes: int):
    """Pad ``points`` to a multiple of ``lanes`` by repeating the last one.
    Returns ``(padded, n_real)``."""
    points = list(points)
    if not points:
        raise ValueError("pad_points needs at least one point")
    n_real = len(points)
    rem = n_real % lanes
    if rem:
        points = points + [points[-1]] * (lanes - rem)
    return points, n_real


def align_chunk(chunk_size: int, lanes: int) -> int:
    """Round a journal chunk size up to a multiple of the sweep lanes."""
    chunk_size = max(1, int(chunk_size))
    lanes = max(1, int(lanes))
    rem = chunk_size % lanes
    return chunk_size + (lanes - rem if rem else 0)
