"""The executable registry (port of the in-process part of
``blockchain_simulator_tpu/utils/aotcache.py``).

The one place the port's built step programs live: a keyed LRU store
(:class:`ExecutableRegistry`, module singleton :data:`registry`) over the
closures that the ``make_*_fn`` factories return.  Factories opt in with
:func:`cached_factory` under the JAX package's names (``"sim"``,
``"segment"``, ``"trace-tick"``, ``"sweep-batched"``,
``"sweep-batched-dynf"``, ``"multi-seed-tick"``, ``"serve-solo"``), so the
registry's ``by_factory`` breakdown reads as JAX's does, and its hit/miss
counters reach every run manifest (utils/obs.py ``cache`` block) and the
scenario server's ``/stats``.  A warm scenario server answers from registry
hits only: the batch group's program is built once and every later request
of the group reuses it.

The JAX module's on-disk layer (``aot_compile``, ``aot_cached``,
``$BLOCKSIM_COMPILE_CACHE``, ``enable_xla_cache``, ``cost_of``) serializes
compiled XLA executables.  The port builds no serializable executable yet:
those functions raise ``NotImplementedError`` naming the CUDA-graph work
(ROADMAP.md §B item 1) that brings one, the ``disk_*`` and
``corrupt_healed`` counters stay 0 and ``persistent_dir`` stays null.

The port's entries are single-device, so every entry counts under the
``"none"`` mesh descriptor of the JAX registry's ``mesh`` breakdown.  This
module imports neither torch nor numpy: a stats read never touches a device.
"""

from __future__ import annotations

import collections
import functools
import threading

_DISK_LAYER = ("the on-disk executable cache comes with the CUDA-graph work of the "
               "port (ROADMAP.md §B item 1): the port builds no serializable "
               "executable yet")


def _display_key(name: str, args: tuple, kwargs: tuple) -> str:
    """Short human-readable key for stats/manifests: the factory name plus
    the config hash of the first dataclass argument (the join key used
    everywhere else in the observability layer)."""
    import dataclasses

    from blockchain_simulator_tpu_torch.utils import obs

    for a in args + tuple(v for _, v in kwargs):
        if dataclasses.is_dataclass(a):
            return f"{name}:{obs.config_hash(a)}"
    return name


class ExecutableRegistry:
    """Keyed LRU store for built callables with hit/miss stats.

    Keys are ``(factory name, args, kwargs)``; every factory argument is
    hashable (frozen ``SimConfig``, ints)."""

    def __init__(self, maxsize: int = 128):
        self.maxsize = maxsize
        self._entries: collections.OrderedDict = collections.OrderedDict()
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.last_key: str | None = None

    # ---------------------------------------------------------- memoize ---
    def get(self, name: str, args: tuple, kwargs: dict, build):
        """Return the cached build for ``(name, args, kwargs)``, building
        (and recording a miss) when absent.  LRU beyond ``maxsize``."""
        key = (name, args, tuple(sorted(kwargs.items())))
        with self._lock:
            if key in self._entries:
                self.hits += 1
                self._entries.move_to_end(key)
                self.last_key = _display_key(name, args, key[2])
                return self._entries[key]
        # build outside the lock: one factory's build must not serialize
        # unrelated factories behind a single mutex
        value = build(*args, **kwargs)
        with self._lock:
            self.misses += 1
            self.last_key = _display_key(name, args, key[2])
            self._entries[key] = value
            self._entries.move_to_end(key)
            while len(self._entries) > self.maxsize:
                self._entries.popitem(last=False)
                self.evictions += 1
        return value

    def clear(self, name: str | None = None) -> None:
        """Drop every entry (``name=None``) or just one factory's entries."""
        with self._lock:
            if name is None:
                self._entries.clear()
                return
            for key in [k for k in self._entries if k[0] == name]:
                del self._entries[key]

    def __len__(self) -> int:
        return len(self._entries)

    # ------------------------------------------------------------ stats ---
    def stats(self) -> dict:
        """Full stats snapshot (tests, artifacts): the JAX registry's keys,
        the disk layer's counters 0 and its directory null."""
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "entries": len(self._entries),
                "disk_hits": 0,
                "disk_misses": 0,
                "disk_saves": 0,
                "disk_errors": 0,
                "corrupt_healed": 0,
                "last_key": self.last_key,
                "persistent_dir": None,
            }

    def stats_snapshot(self) -> dict:
        """Thread-safe point-in-time snapshot for stats endpoints: the full
        :meth:`stats` record plus a per-factory entry breakdown
        (``by_factory``) and each factory's ``{mesh descriptor: entries}``
        (``mesh``; every port entry counts under ``"none"``)."""
        with self._lock:
            by_factory: dict[str, int] = {}
            for key in self._entries:
                by_factory[key[0]] = by_factory.get(key[0], 0) + 1
            snap = self.stats()  # RLock: safe to re-enter
            snap["by_factory"] = dict(sorted(by_factory.items()))
            snap["mesh"] = {k: {"none": v} for k, v in snap["by_factory"].items()}
            return snap

    def manifest(self) -> dict:
        """The compact ``cache`` block utils/obs.py attaches to every
        runs.jsonl line.  Pure counter reads."""
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "key": self.last_key,
                "mesh": None,
                "corrupt_healed": 0,
                "persistent_dir": None,
            }


registry = ExecutableRegistry()


def cached_factory(name: str):
    """Decorator: memoize a ``factory(*hashable_args) -> callable`` in the
    process-wide :data:`registry` (the ``functools.lru_cache`` replacement).
    ``wrapper.__wrapped__`` is the raw factory and ``wrapper.cache_clear()``
    drops this factory's entries only, as with ``lru_cache``."""

    def deco(build):
        @functools.wraps(build)
        def wrapper(*args, **kwargs):
            return registry.get(name, args, kwargs, build)

        wrapper.cache_clear = lambda: registry.clear(name)
        return wrapper

    return deco


# ------------------------------------------------------- persistent layer ---


def persistent_dir():
    """The JAX package's serialized-executable directory: refused."""
    raise NotImplementedError(_DISK_LAYER)


def enable_xla_cache():
    """The JAX package's XLA compilation cache: refused."""
    raise NotImplementedError(_DISK_LAYER)


def aot_compile(name: str, jitted, example_args: tuple, cfg=None, extra=None):
    """JAX's ahead-of-time compile with the on-disk round trip: refused."""
    raise NotImplementedError(_DISK_LAYER)


def aot_cached(name: str, jitted_factory, example_args: tuple, cfg=None, extra=None):
    """Registry-memoized :func:`aot_compile`: refused."""
    raise NotImplementedError(_DISK_LAYER)


def cost_of(staged):
    """XLA's cost analysis of a staged program: refused (the port's kernels
    state their bounds in chip_smoke.py instead)."""
    raise NotImplementedError(_DISK_LAYER)
