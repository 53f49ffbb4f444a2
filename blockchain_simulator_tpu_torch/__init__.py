"""blockchain_simulator_tpu_torch — the PyTorch / CUDA port of
``blockchain_simulator_tpu`` for NVIDIA Hopper GPUs.

A second package beside the JAX one, which stays the reference: the same
configs give the same simulations, held bit for bit against the JAX package
by ``tests/test_torch_*.py``.  It imports torch and numpy, never jax nor the
JAX package.  Its one hand-written kernel is the ring push
(``csrc/ring_push.cu``, bound in ``ops/ring_kernel.py``).

Ported so far: PBFT, Raft and Paxos on the full mesh and over the gossip
topology (the tick engines, with edge or stat delivery), PBFT's
round-blocked fast path and Raft's heartbeat-blocked path (``schedule=
"auto"`` picks them at n >= 4096), the mixed shard sim (BASELINE config 5:
Raft shards under a cross-shard PBFT layer, on the tick engine and on the
heartbeat path; the Raft step runs over a leading shard axis), fault
sweeps with the fault counts as run-time operands (BASELINE config 4: one
batch of lanes), multi-seed runs, checkpoints in the JAX package's archive
format, the sparse topologies (the kregular overlay and the committee
hierarchy), probe traces of every schedule (``run_traced``, beside
``run_simulation``), run manifests and the run log (``utils/obs.py``), the
command line (``python -m blockchain_simulator_tpu_torch``, ``cli.py``), the
scenario server (``serve/``) with its registry, telemetry, health gate, WAL
and chaos points, and the C++ reference engine's wrapper.
Entry points run on the CUDA card unless the caller passes
``device="cpu"`` (``--device cpu`` on the command line).

Subpackages
-----------
- ``utils``  — config and the wire codec (copies of the JAX package's),
  checkpoints (``checkpoint.py``), probe traces and the Chrome-trace export
  (``trace.py``), run manifests (``obs.py``), timing syncs (``sync.py``),
  the threefry and Philox streams, the binomial and categorical draws,
  XLA:CPU's float32 math.
- ``ops``    — delay samplers, ring buffers and the ring-push kernel, edge,
  stat and gossip delivery, the gossip topology.
- ``models`` — the PBFT, Raft and Paxos tick engines, PBFT's round-blocked
  fast path, Raft's heartbeat-blocked path and the mixed shard sim.
- ``topo``   — the kregular overlay tables and the committee hierarchy.
- ``parallel`` — fault and seed sweeps on one device (``sweep.py``).
- ``serve``  — the scenario server and its daemon (``python -m
  blockchain_simulator_tpu_torch.serve``), with the chaos points
  (``chaos/``), the executable registry (``utils/aotcache.py``), host
  telemetry (``utils/telemetry.py``) and the health probe
  (``utils/health.py``).
- ``cli``    — the command line.
"""

from blockchain_simulator_tpu_torch.utils.config import SimConfig  # noqa: F401
from blockchain_simulator_tpu_torch.runner import run_simulation  # noqa: F401
from blockchain_simulator_tpu_torch.utils.trace import run_traced  # noqa: F401

__version__ = "0.1.0"
