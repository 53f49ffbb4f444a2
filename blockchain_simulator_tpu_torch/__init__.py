"""blockchain_simulator_tpu_torch — the PyTorch / CUDA port of
``blockchain_simulator_tpu`` for NVIDIA Hopper GPUs.

A second package beside the JAX one, which stays the reference: the same
configs give the same simulations, held bit for bit against the JAX package
by ``tests/test_torch_*.py``.  It imports torch and numpy, never jax nor the
JAX package.  Its one hand-written kernel is the ring push
(``csrc/ring_push.cu``, bound in ``ops/ring_kernel.py``).

Ported so far (slices 1 and 2): PBFT on the full mesh, the tick engine with
edge or stat delivery and the round-blocked fast path that ``schedule="auto"``
picks at n >= 4096 (the bench headline, n = 100,000).  Entry points run on the
CUDA card unless the caller passes ``device="cpu"``.

Subpackages
-----------
- ``utils``  — config (a copy of the JAX package's), the threefry and Philox
  streams, the binomial and categorical draws, XLA:CPU's float32 math.
- ``ops``    — delay samplers, ring buffers and the ring-push kernel, edge and
  stat delivery.
- ``models`` — the PBFT tick engine and the round-blocked fast path.
"""

from blockchain_simulator_tpu_torch.utils.config import SimConfig  # noqa: F401
from blockchain_simulator_tpu_torch.runner import run_simulation  # noqa: F401

__version__ = "0.1.0"
