"""Many-rank execution: the same sharded program over processes (port of
``blockchain_simulator_tpu/parallel/multihost.py``).

JAX runs one controller over a global mesh after
``jax.distributed.initialize``.  PyTorch runs one process a rank:
:func:`init_multihost` joins the process group (NCCL on the card, rank r on
``cuda:(r % cards)``; gloo on the CPU; a TCP rendezvous at the
coordinator), and :func:`run_sharded_multihost`, called in every rank, runs
one node-sharded simulation (parallel/shard.py) and returns the full
metrics on every rank.  The result equals JAX's run over a global mesh of
the same size, bit for bit: every draw is keyed by (seed, tick, channel,
shard), never by process.  :func:`run_seed_sweep_multihost` runs a seed
sweep over a nodes mesh of the ranks (parallel/sweep.py ``mesh=``).

:func:`launch` is the single-process door the command line (``--shards
W``) and the tests use: it starts W rank processes, joins them against a
deadline, and kills them all on any failure.  Every process group has a
timeout, so a rank that hangs in a collective fails its run within it.
*Placement on the cards*: rank r computes on ``cuda:(r % cards)``.  The
ranks of one nodes row share a NCCL communicator, which refuses two ranks
on one card, so a row needs as many cards as it has ranks; sweep rows share
no communicator and may share cards (two sweep rows on one card run side by
side).  A ``cuda`` grid whose nodes rows outnumber the visible cards raises
before any rank starts: it never falls back to the CPU or to fewer ranks.

CLI, one process a rank: ``python -m
blockchain_simulator_tpu_torch.parallel.multihost --coordinator HOST:PORT
--num-processes N --process-id I [--device cpu] [sim flags]``; rank 0
prints one JSON line (JAX's: ``process_count``, ``device_count`` and the
metrics).  ``--config JSON`` sets any further SimConfig field, and
``--report`` adds the final state's sha256 digests, the collectives the
mesh issued, the ring kernel's launches and pushes, and the run's wall.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import socket
import sys
import time
import traceback

DEFAULT_GROUP_TIMEOUT_S = 300.0


def init_multihost(coordinator: str, num_processes: int, process_id: int,
                   device: str = "cuda", timeout_s: float = DEFAULT_GROUP_TIMEOUT_S) -> None:
    """Join (or start, for process 0) the process group: NCCL with rank r
    on ``cuda:(r % cards)`` for ``device="cuda"`` (the module's placement
    rule), gloo for ``"cpu"``, rendezvous over TCP at ``coordinator``
    (``HOST:PORT``); every collective of the group (and of the groups
    parallel/mesh.make_mesh makes in it) fails after ``timeout_s``."""
    import torch
    import torch.distributed as dist

    if device == "cuda":
        n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n_cards == 0:
            raise RuntimeError(
                f"rank {process_id} of a NCCL group needs a card; none visible "
                "(no fallback to the CPU)")
        torch.cuda.set_device(process_id % n_cards)
        backend = "nccl"
    elif device == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    from blockchain_simulator_tpu_torch.parallel import mesh

    mesh.GROUP_TIMEOUT = datetime.timedelta(seconds=float(timeout_s))
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}", world_size=int(num_processes),
        rank=int(process_id), timeout=mesh.GROUP_TIMEOUT)


def shutdown() -> None:
    """Leave the process group (a no-op outside one), and forget the grid
    groups made in it (parallel/mesh.make_mesh)."""
    import torch.distributed as dist

    from blockchain_simulator_tpu_torch.parallel import mesh

    mesh._GRIDS.clear()
    mesh._COUNTS.clear()
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def run_sharded_multihost(cfg, n_node_shards: int | None = None, seed=None) -> dict:
    """Run one node-sharded simulation over every rank of the group.  Call
    it in every process (it is one SPMD program); every process returns
    the full metrics dict (the final state is gathered on every rank)."""
    from blockchain_simulator_tpu_torch.parallel.mesh import make_mesh
    from blockchain_simulator_tpu_torch.parallel.shard import run_sharded

    return run_sharded(cfg, make_mesh(n_node_shards=n_node_shards), seed=seed)


def run_seed_sweep_multihost(cfg, seeds) -> list:
    """Run a seed sweep over a nodes mesh of every rank of the group
    (parallel/sweep.run_seed_sweep with ``mesh=``, as JAX's ``--shards W
    --seeds ...``): each seed's row is ``run_sharded`` over the ranks.  Call
    it in every process; every process returns every seed's metrics."""
    from blockchain_simulator_tpu_torch.parallel.mesh import make_mesh
    from blockchain_simulator_tpu_torch.parallel.sweep import run_seed_sweep

    return run_seed_sweep(cfg, seeds, mesh=make_mesh())


# ------------------------------------------------------------- launcher ----


def free_port() -> int:
    """A free localhost TCP port for a group's rendezvous."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def check_ranks(world_size: int, device: str, n_nodes: int | None = None) -> None:
    """Refuse a group the machine cannot hold, before any rank starts: on
    the cards, a nodes row of ``n_nodes`` ranks (the whole world by
    default) needs as many cards (the placement rule, module docstring)."""
    if world_size < 1:
        raise ValueError(f"world_size must be >= 1, got {world_size}")
    n_nodes = world_size if n_nodes is None else int(n_nodes)
    if n_nodes < 1 or world_size % n_nodes:
        raise ValueError(f"{world_size} ranks do not form rows of {n_nodes}")
    if device == "cuda":
        import torch

        n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n_cards == 0 or n_nodes > n_cards:
            raise RuntimeError(
                f"a nodes row of {n_nodes} NCCL ranks needs {n_nodes} cards; {n_cards} "
                "visible (no fallback to the CPU or to fewer ranks)")
    elif device != "cpu":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")


def _rank_job(job_file: str, coordinator: str, world_size: int, rank: int,
              device: str, timeout_s: float) -> int:
    """One rank of :func:`launch`: join the group, run the pickled job,
    write its result (or the traceback) beside the job file, leave."""
    import pickle

    try:
        import torch

        if device == "cpu":
            torch.set_num_threads(1)
        with open(job_file, "rb") as f:
            job, args = pickle.load(f)
        init_multihost(coordinator, world_size, rank, device, timeout_s)
        out = ("ok", job(*args))
        code = 0
    except BaseException:  # reported to the launcher, which fails the run
        out = ("err", traceback.format_exc())
        code = 1
    finally:
        try:
            shutdown()
        except Exception:
            pass
    tmp = f"{job_file}.{rank}.tmp"
    with open(tmp, "wb") as f:
        pickle.dump(out, f)
    os.replace(tmp, f"{job_file}.{rank}")
    return code


def launch(job, world_size: int, args=(), device: str = "cuda",
           timeout_s: float = 600.0, group_timeout_s: float | None = None,
           mesh_shape: tuple | None = None) -> list:
    """Run ``job(*args)`` in ``world_size`` new rank processes of one group
    and return every rank's result, in rank order.  ``job`` is a function
    importable by its module and name (each rank is a fresh interpreter:
    ``python -m blockchain_simulator_tpu_torch.parallel.multihost --job``),
    ``args`` picklable; inside it, parallel/mesh.make_mesh gives the rank's
    mesh.  ``mesh_shape`` is the ``(n_sweep, n_nodes)`` grid the job makes
    (``(1, world_size)`` by default): it sets the placement check.  The
    ranks run NCCL on the cards unless the caller asks for gloo on the CPU
    with ``device="cpu"``; on the cards rank r computes on ``cuda:(r %
    cards)``, so a nodes row needs as many cards as ranks and sweep rows
    may share them (module docstring).  The ranks are joined against
    ``timeout_s``; a rank that fails, dies or outlives the deadline kills
    them all and raises ``RuntimeError``.  ``device="cuda"`` with a nodes
    row longer than the cards raises before any rank starts."""
    import pickle
    import subprocess
    import tempfile

    n_sweep, n_nodes = (1, world_size) if mesh_shape is None else map(int, mesh_shape)
    if n_sweep * n_nodes != world_size:
        raise ValueError(f"mesh {n_sweep}x{n_nodes} needs {n_sweep * n_nodes} ranks, "
                         f"not {world_size}")
    check_ranks(world_size, device, n_nodes)
    gt = group_timeout_s if group_timeout_s is not None else timeout_s
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in sys.path if p and os.path.isdir(p)])
    with tempfile.TemporaryDirectory(prefix="blocksim-ranks-") as tmp:
        job_file = os.path.join(tmp, "job.pkl")
        with open(job_file, "wb") as f:
            pickle.dump((job, tuple(args)), f)
        coordinator = f"127.0.0.1:{free_port()}"
        errs = [open(f"{job_file}.{r}.err", "wb") for r in range(world_size)]
        procs = [subprocess.Popen(
            [sys.executable, "-m", "blockchain_simulator_tpu_torch.parallel.multihost",
             "--job", job_file, "--coordinator", coordinator,
             "--num-processes", str(world_size), "--process-id", str(r),
             "--device", device, "--group-timeout-s", str(gt)],
            env=env, stdout=subprocess.DEVNULL, stderr=errs[r])
            for r in range(world_size)]
        deadline = time.monotonic() + float(timeout_s)
        results: dict = {}
        failed: dict = {}
        try:
            while len(results) + len(failed) < world_size:
                for r, p in enumerate(procs):
                    if r in results or r in failed or p.poll() is None:
                        continue
                    path = f"{job_file}.{r}"
                    if not os.path.exists(path):
                        with open(f"{job_file}.{r}.err", "rb") as f:
                            err = f.read().decode(errors="replace")[-4000:]
                        failed[r] = f"exited with code {p.returncode} and no result:\n{err}"
                        continue
                    with open(path, "rb") as f:
                        status, out = pickle.load(f)
                    if status == "err":
                        failed[r] = f"failed:\n{out}"
                    else:
                        results[r] = out
                if failed and time.monotonic() > deadline:
                    break
                if failed:
                    # the peers of a failed rank fail soon after it (a closed
                    # connection, or the group's timeout): report them all
                    deadline = min(deadline, time.monotonic() + 3.0)
                elif time.monotonic() > deadline:
                    raise RuntimeError(
                        f"sharded run: {world_size - len(results)} of {world_size} "
                        f"ranks still running after {timeout_s:.0f} s; killed")
                time.sleep(0.05)
            if failed:
                raise RuntimeError("sharded run: " + "\n".join(
                    f"rank {r} {msg}" for r, msg in sorted(failed.items())))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p, f in zip(procs, errs):
                p.wait()
                f.close()
    return [results[r] for r in range(world_size)]


def sharded_report(cfg, seed=None, topo_layout=None) -> dict:
    """One sharded run on this rank's mesh, reported: ``metrics``, the
    sha256 of every final-state field (``state_sha256``, convert.py),
    ``collectives`` (by kind, over the run), the ring kernel's ``launches``
    and ``pushes`` (ops/ring_kernel.py, this rank's), ``wall_s`` and
    ``split_s``: a node-sharded run's wall split into ``init_s`` (this
    rank's rows of the init), ``body_s`` (the run) and ``gather_s`` (the
    final state all-gathered); empty for the overlay.  ``topo_layout``
    runs a kregular or committee config through
    parallel/sweep.sharded_topo_sim_fn with that layout."""
    from blockchain_simulator_tpu_torch import convert
    from blockchain_simulator_tpu_torch.models.base import canonical_fault_cfg, sim_metrics
    from blockchain_simulator_tpu_torch.ops import ring_kernel
    from blockchain_simulator_tpu_torch.parallel.mesh import make_mesh
    from blockchain_simulator_tpu_torch.utils import threefry
    from blockchain_simulator_tpu_torch.utils.sync import force_sync

    mesh = make_mesh()
    key = threefry.key(cfg.seed if seed is None else seed)
    split: dict = {}
    if topo_layout is None:
        from blockchain_simulator_tpu_torch.parallel.shard import make_sharded_sim_fn

        sim = make_sharded_sim_fn(cfg, mesh)

        def run():
            return sim(key, split)
    else:
        from blockchain_simulator_tpu_torch.parallel.sweep import sharded_topo_sim_fn

        sim = sharded_topo_sim_fn(canonical_fault_cfg(cfg), mesh, layout=topo_layout)

        def run():
            return sim(key, cfg.faults.resolved_n_crashed(cfg.n), cfg.faults.n_byzantine)
    mesh.reset_counts()
    ring_kernel.launches = ring_kernel.pushes = 0
    t0 = time.perf_counter()
    final = force_sync(run())
    wall = time.perf_counter() - t0
    return {"metrics": sim_metrics(cfg, final),
            "state_sha256": convert.state_digests(convert.state_to_numpy(final)),
            "collectives": dict(mesh.counts),
            "launches": ring_kernel.launches, "pushes": ring_kernel.pushes,
            "wall_s": wall, "split_s": split}


def sharded_reports(runs) -> list:
    """A :func:`launch` job: :func:`sharded_report` for each ``(cfg, seed,
    topo_layout)`` of ``runs``, one after the other in this rank's group
    (one group start serves many runs)."""
    return [sharded_report(cfg, seed, layout) for cfg, seed, layout in runs]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="blockchain_simulator_tpu_torch.parallel.multihost")
    p.add_argument("--coordinator", required=True, help="HOST:PORT of process 0")
    p.add_argument("--job", default=None,
                   help="a launch() job file: run it as this rank (parallel/"
                        "multihost.launch writes it; the sim flags are ignored)")
    p.add_argument("--group-timeout-s", type=float, default=DEFAULT_GROUP_TIMEOUT_S,
                   help="every collective of the group fails after this long")
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda: NCCL, rank r on cuda:(r %% cards) (the default); cpu: gloo")
    p.add_argument("--protocol", default="pbft")
    p.add_argument("--n", type=int, default=64)
    p.add_argument("--sim-ms", type=int, default=2500)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--delivery", default="edge")
    p.add_argument("--serialization", choices=["on", "off"], default="on")
    p.add_argument("--schedule", choices=["tick", "round", "auto"],
                   default="auto", help="stepping granularity; 'round' pins "
                   "the PBFT round-blocked fast path (models/pbft_round.py)")
    p.add_argument("--config", default=None, metavar="JSON",
                   help="further SimConfig fields as a JSON object (they win "
                        "over the flags above)")
    p.add_argument("--report", action="store_true",
                   help="add the final state's digests, the collectives, the "
                        "ring kernel's launches and the wall to the line")
    args = p.parse_args(argv)
    if args.job:
        return _rank_job(args.job, args.coordinator, args.num_processes,
                         args.process_id, args.device, args.group_timeout_s)

    import torch

    from blockchain_simulator_tpu_torch.utils.config import SimConfig

    if args.device == "cpu":
        torch.set_num_threads(1)
    init_multihost(args.coordinator, args.num_processes, args.process_id, args.device,
                   args.group_timeout_s)
    try:
        kw = dict(
            protocol=args.protocol,
            n=args.n,
            sim_ms=args.sim_ms,
            seed=args.seed,
            delivery=args.delivery,
            model_serialization=args.serialization == "on",
            schedule=args.schedule,
        )
        kw.update(json.loads(args.config) if args.config else {})
        cfg = SimConfig(**kw)
        if args.report:
            rep = sharded_report(cfg)
            m = dict(rep.pop("metrics"), **rep)
        else:
            m = run_sharded_multihost(cfg)
        if args.process_id == 0:
            import torch.distributed as dist

            print(json.dumps({"process_count": dist.get_world_size(),
                              "device_count": dist.get_world_size(), **m}),
                  flush=True)
    finally:
        shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
