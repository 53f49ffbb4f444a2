"""Sparse and hierarchical topologies (port of ``blockchain_simulator_tpu/topo``).

- :mod:`~blockchain_simulator_tpu_torch.topo.spec` — ``TopoSpec`` and the
  seeded circulant overlay tables behind ``topology="kregular"``, which the
  models consume through the gather primitives of ``ops/gatherdeliv.py``
  (O(N·k) a tick instead of O(N²), equal to the dense run at k = N-1);
- :mod:`~blockchain_simulator_tpu_torch.topo.committee` — the two-level
  committee hierarchy behind ``topology="committee"``: the flat protocol
  inside each committee, committees in turn, and an outer aggregate over
  their milestones.
"""

from blockchain_simulator_tpu_torch.topo.spec import TopoSpec  # noqa: F401
