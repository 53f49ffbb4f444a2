"""Scenario serving: the warm-program simulation daemon (port of
``blockchain_simulator_tpu/serve``).

``python -m blockchain_simulator_tpu_torch.serve`` runs the HTTP daemon
(serve/__main__.py); :class:`ScenarioServer` is the in-process core the
daemon, chip_smoke.py and the tests drive.  It serves on the CUDA card
unless ``device="cpu"`` (``--device cpu``) asks for the CPU.  The request
schema, typed errors, WAL format, span and metric names are the JAX
package's (README "Scenario serving").  The fleet layer (router, replica
manager) comes with a later slice; ``serve/fleet.py`` holds only its WAL
lease.
"""

from blockchain_simulator_tpu_torch.serve.schema import (  # noqa: F401
    AdmissionPausedError,
    DispatchFailedError,
    InvalidRequestError,
    QueueFullError,
    ReplicaLostError,
    RequestTimeoutError,
    ScenarioRequest,
    ServeError,
    ShuttingDownError,
    UnbatchableRequestError,
    parse_request,
)
from blockchain_simulator_tpu_torch.serve.server import (  # noqa: F401
    CircuitBreaker,
    PendingResponse,
    ScenarioServer,
)
from blockchain_simulator_tpu_torch.serve.wal import WriteAheadLog  # noqa: F401
