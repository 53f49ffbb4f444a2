"""obsim — in-program consensus observability (port of
``blockchain_simulator_tpu/obsim``).

Probe taps, invariant monitors on the final state and first-divergence
forensics that ride INSIDE the simulation runs.  Every value obsim makes on
the device is an ordinary tensor returned beside the final state, and only
:mod:`obsim.host` (which runs after the run) touches ``utils/telemetry``.

- :mod:`obsim.schema` — :class:`~obsim.schema.ProbeConfig` (frozen,
  hashable: it rides registry keys), the per-protocol field registry,
  window-boundary math, host-side summaries (a copy of JAX's, which
  imports no JAX).
- :mod:`obsim.taps` — the taps as torch ops on the state's device:
  per-sample counters, windowed reductions, liveness lag, monitors.
- :mod:`obsim.build` — probed twins of the runner and sweep program
  factories, registry entries under JAX's ``consobs-*`` names.
- :mod:`obsim.diverge` — first-divergence forensics over two probe series.
- :mod:`obsim.host` — run probed programs, summarize, trip the flight
  recorder on monitor violations.
"""
