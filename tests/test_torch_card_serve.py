"""The port's scenario server, telemetry profiler and health probe on the
card.

The CPU runs are held to the JAX package by tests/test_torch_serve.py,
test_torch_telemetry.py and test_torch_health.py; here the card is held to
itself and to the CPU.  Every case is marked ``cuda`` and skips without a
card.  This file imports no JAX code:

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_card_serve.py -m cuda
"""

from __future__ import annotations

import json

import pytest
import torch

from blockchain_simulator_tpu_torch.serve import ScenarioServer
from blockchain_simulator_tpu_torch.utils import aotcache, health, telemetry

TPL = {"protocol": "pbft", "n": 256, "sim_ms": 300, "delivery": "stat", "schedule": "round",
       "stat_sampler": "exact", "model_serialization": False}
POINTS = [dict(TPL, seed=s, faults={"n_byzantine": f}) for s, f in [(0, 0), (1, 3), (2, 40),
                                                                    (3, 85)]]


@pytest.fixture
def cuda_device():
    # decided here, never at import: every xdist worker must collect the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; on the H100: JAX_PLATFORMS=cpu "
                    "python -m pytest tests/test_torch_card_serve.py -m cuda")
    return "cuda"


def _served(points, max_batch, device):
    with ScenarioServer(max_batch=max_batch, max_wait_ms=1.0, start=False,
                        device=device) as srv:
        pends = [srv.submit(dict(p)) for p in points]
        srv.start()
        return [p.result(600) for p in pends]


@pytest.mark.cuda
def test_card_batch_of_four_equals_solo_and_cpu(cuda_device):
    """A batched flush of 4 on the card equals the 4 solo answers on the
    card and the batch on the CPU (exact sampler)."""
    batch = _served(POINTS, 4, cuda_device)
    assert [r["batch"]["mode"] for r in batch] == ["batched"] * 4
    solo = [_served([p], 1, cuda_device)[0] for p in POINTS]
    assert [r["batch"]["mode"] for r in solo] == ["solo"] * 4
    cpu = _served(POINTS, 4, "cpu")
    assert [r["metrics"] for r in batch] == [r["metrics"] for r in solo] == \
        [r["metrics"] for r in cpu]


@pytest.mark.cuda
def test_card_warm_requests_add_no_registry_miss(cuda_device):
    with ScenarioServer(max_batch=2, max_wait_ms=1.0, device=cuda_device) as srv:
        srv.prewarm(dict(TPL))
        before = aotcache.registry.stats()["misses"]
        assert srv.request(dict(TPL, seed=9), wait_s=600)["status"] == "ok"
        pair = [srv.submit(dict(TPL, seed=s)) for s in (10, 11)]
        assert all(p.result(600)["status"] == "ok" for p in pair)
        assert aotcache.registry.stats()["misses"] == before


@pytest.mark.cuda
def test_card_profile_region_records_a_kernel(cuda_device, tmp_path, monkeypatch):
    monkeypatch.setenv(telemetry.PROFILE_ENV, str(tmp_path))
    a = torch.ones((256, 256), device=cuda_device)
    with telemetry.profile_region("card"):
        (a @ a).sum()
    (d,) = list(tmp_path.iterdir())
    doc = json.loads((d / telemetry.PROFILE_TRACE).read_text())
    assert any(e.get("cat") == "kernel" for e in doc["traceEvents"])


@pytest.mark.cuda
def test_card_health_probe(cuda_device):
    rec = health.probe_backend()
    assert rec["verdict"] == "healthy" and rec["backend"] == "cuda"
    assert rec["device"] == torch.cuda.get_device_name(0)
    assert rec["probe_value"] == 128.0 ** 3
