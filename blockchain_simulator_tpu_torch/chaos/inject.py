"""Chaos points: named fault-injection hooks the real stack calls through.

A chaos point is one line in production code::

    from blockchain_simulator_tpu_torch.chaos import inject
    ...
    inject.chaos_point("sweep.dyn_dispatch", canon=canon, n=len(points))

Disarmed (the default, and the only state tests/serving ever see unless a
drill arms one) it costs a global read and a predicted branch.  Armed, the
installed :class:`ChaosController` consults the actions registered for
that site and may sleep (slow/hang) or raise (:class:`ChaosFault`,
:class:`ChaosKill`) — *through the same exception paths a real
infrastructure fault would take*, which is the point: the degrade
machinery (degrade-to-solo, circuit breakers, batcher supervision,
quarantine) is exercised by the exact control flow it defends.

Determinism: actions trigger on **counted** firings, never wall-clock or
probability — ``fail_next(site, n=3)`` fails exactly the next three
firings of that site.  The controller's seeded ``rng`` exists for drill
scripts to draw request mixes and corruption offsets reproducibly; the
hook layer itself is count-exact so one chaos seed replays one fault
schedule bit-for-bit.  This module is a copy of the JAX package's.

Registered sites in the port (grep ``chaos_point(`` for ground truth):

- ``sweep.dyn_dispatch`` — parallel/sweep._dispatch_dyn_points, before
  the batched dispatch (the sweeps' and the server's shared batched path);
- ``serve.solo_dispatch`` — serve/dispatch._solo_metrics, before the solo
  program runs (ctx carries ``req_id`` so poison can target one request);
- ``serve.batcher`` — the ScenarioServer batcher loop, once per iteration
  after the arrivals drain (where :class:`ChaosKill` simulates a dead
  batcher thread for the supervision drill).

The JAX package's other sites (``fleet.send``, ``fleet.handoff``,
``sweep.chunk``, ``query.step``) come with the slices that port the fleet
router, the sweep journal and the adaptive queries.
"""

from __future__ import annotations

import threading
import time
from random import Random

__all__ = [
    "ChaosController",
    "ChaosFault",
    "ChaosKill",
    "chaos_point",
    "controller",
]


class ChaosFault(RuntimeError):
    """An injected dispatch/infrastructure failure (the generic raise)."""


class ChaosKill(ChaosFault):
    """An injected batcher-thread death: raised at the ``serve.batcher``
    site it escapes the per-group flush guard on purpose, so only the
    batcher *supervisor* (serve/server.py) can save the daemon."""


class _Action:
    """One armed behavior at one site: fires for ``count`` triggerings
    (None = forever), optionally only when ``match(ctx)`` holds."""

    __slots__ = ("kind", "count", "fired", "exc", "sleep_s", "match")

    def __init__(self, kind, count=1, exc=None, sleep_s=0.0, match=None):
        self.kind = kind
        self.count = count
        self.fired = 0
        self.exc = exc
        self.sleep_s = sleep_s
        self.match = match

    def live(self) -> bool:
        return self.count is None or self.fired < self.count


class ChaosController:
    """Seeded, armable fault schedule over the registered chaos points.

    Install with :func:`controller` (context manager) or
    :meth:`install`/:meth:`uninstall`; only ONE controller is active per
    process (the drill runs scenarios sequentially).  All mutation is
    lock-guarded: chaos points fire from the batcher thread and HTTP
    worker threads concurrently.
    """

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self.rng = Random(self.seed)
        self._actions: dict[str, list[_Action]] = {}
        self._lock = threading.Lock()
        # every fired injection, in firing order: the drill's determinism
        # check compares this schedule across the two same-seed runs
        self.events: list[tuple[str, str]] = []

    # ------------------------------------------------------------ arming ---
    def _arm(self, site: str, action: _Action) -> None:
        with self._lock:
            self._actions.setdefault(site, []).append(action)

    def fail_next(self, site: str, n: int = 1, exc=ChaosFault,
                  match=None) -> None:
        """Raise ``exc`` on the next ``n`` firings of ``site``."""
        self._arm(site, _Action("fail", count=n, exc=exc, match=match))

    def kill_next(self, site: str, n: int = 1) -> None:
        """Raise :class:`ChaosKill` on the next ``n`` firings — the
        thread-death injection (only meaningful at ``serve.batcher``)."""
        self._arm(site, _Action("fail", count=n, exc=ChaosKill))

    def hang_next(self, site: str, seconds: float, n: int = 1,
                  match=None) -> None:
        """Sleep ``seconds`` on the next ``n`` firings (a bounded stand-in
        for a wedged dispatch: long relative to request timeouts).
        ``match(ctx)`` narrows the firings (e.g. one fleet replica)."""
        self._arm(site, _Action("hang", count=n, sleep_s=float(seconds),
                                match=match))

    def slow_next(self, site: str, seconds: float, n: int = 1,
                  match=None) -> None:
        """Same mechanics as hang, logged distinctly: latency, not loss."""
        self._arm(site, _Action("slow", count=n, sleep_s=float(seconds),
                                match=match))

    def poison(self, site: str, req_id: str, exc=ChaosFault) -> None:
        """Raise forever at ``site`` whenever ``ctx['req_id'] == req_id`` —
        a request that fails every dispatch, batched or solo (the
        quarantine drill)."""
        self._arm(site, _Action(
            "poison", count=None, exc=exc,
            match=lambda ctx, rid=req_id: ctx.get("req_id") == rid,
        ))

    # ------------------------------------------------------------- firing ---
    def fire(self, site: str, ctx: dict) -> None:
        sleep_s = 0.0
        raise_exc = None
        with self._lock:
            for action in self._actions.get(site, ()):
                if not action.live():
                    continue
                if action.match is not None and not action.match(ctx):
                    continue
                action.fired += 1
                self.events.append((site, action.kind))
                if action.kind in ("hang", "slow"):
                    sleep_s = action.sleep_s
                else:
                    raise_exc = action.exc
                break  # one action per firing: schedules stay count-exact
        if sleep_s:
            time.sleep(sleep_s)
        if raise_exc is not None:
            raise raise_exc(f"chaos[{site}] injected {raise_exc.__name__} "
                            f"(seed={self.seed})")

    def schedule(self) -> list[str]:
        """The fired-injection log as stable strings (the determinism
        artifact field: two same-seed runs must produce equal schedules)."""
        with self._lock:
            return [f"{site}:{kind}" for site, kind in self.events]

    # ------------------------------------------------------- installation ---
    def install(self) -> "ChaosController":
        global _controller
        _controller = self
        return self

    def uninstall(self) -> None:
        global _controller
        if _controller is self:
            _controller = None

    def __enter__(self) -> "ChaosController":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()


_controller: ChaosController | None = None


def controller(seed: int = 0) -> ChaosController:
    """``with chaos.controller(seed) as ctl: ctl.fail_next(...)`` — the
    drill idiom.  Installation is process-global; the context manager
    guarantees the points disarm even when a scenario dies."""
    return ChaosController(seed)


def chaos_point(site: str, **ctx) -> None:
    """The production-side hook: a no-op unless a controller is installed.

    Keyword context (``req_id``, ``canon``...) is matched by targeted
    actions (poison); plain counted actions ignore it."""
    c = _controller
    if c is not None:
        c.fire(site, ctx)
