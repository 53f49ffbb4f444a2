"""The sweep axis of the port on the card: ``chip_smoke.py``'s mesh-sweep
parts as tests.

The CPU grids of gloo ranks are held to the JAX package by
tests/test_torch_mesh_sweep.py; here the card's ranks are held to the JAX
golden (golden/mesh_sweep_s0.json, JAX's sweep over a (2, 1) mesh of host
devices):

- (a) NCCL at world size 1: a sweep over ``make_mesh(1, 1)`` equals the
  plain sweep's rows;
- (b) two ranks of a (2, 1) grid on one card (sweep rows share no
  communicator, so rank r computes on ``cuda:(r % cards)``): config 2's
  journaled Byzantine sweep equals the golden row for row, and both ranks
  launch the ring kernel;
- (c) the same sweep on the same journal replays with 0 dispatches;
- on a machine with four cards, NCCL nodes rows: a (2, 2) grid's lanes
  (the tick engine, the round path, the heartbeat path) equal JAX's rows
  over a (2, 2) mesh, and a seed sweep over a (1, 2) grid JAX's
  ``run_sharded`` over 2 devices (golden); with fewer cards it skips.

Every case is marked ``cuda`` and skips without a card.  This file imports
no JAX code:

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_card_mesh_sweep.py -m cuda
"""

from __future__ import annotations

import json
import pathlib
import sys

import pytest
import torch

from blockchain_simulator_tpu_torch.parallel import multihost

REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = REPO / "blockchain_simulator_tpu_torch" / "golden" / "mesh_sweep_s0.json"


@pytest.fixture
def cuda_device():
    # decided here, never at import: every xdist worker must collect the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; on the H100: JAX_PLATFORMS=cpu "
                    "python -m pytest tests/test_torch_card_mesh_sweep.py -m cuda")
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    import chip_smoke

    return chip_smoke


def _rows(rows) -> str:
    return json.dumps(json.loads(json.dumps(rows)), sort_keys=True)


@pytest.mark.cuda
def test_card_world_size_1_mesh_equals_plain_rows(cuda_device, tmp_path):
    (a,) = multihost.launch(cuda_device.mesh_sweep_job, 1, args=("a", str(tmp_path / "j")),
                            device="cuda", timeout_s=600)
    assert a["device"].startswith("cuda")
    assert _rows(a["mesh_rows"]) == _rows(a["plain_rows"])
    assert a["launches"] > 0


@pytest.mark.cuda
def test_card_two_sweep_ranks_on_one_card_equal_golden_and_replay(cuda_device, tmp_path):
    e = json.loads(GOLDEN.read_text())["entries"]["card@2"]
    path = str(tmp_path / "j")
    runs = [multihost.launch(cuda_device.mesh_sweep_job, 2, args=(part, path), device="cuda",
                             timeout_s=600, mesh_shape=(2, 1)) for part in ("b", "c")]
    for ranks in runs:
        for r in ranks:
            assert r["device"].startswith("cuda")
            assert _rows(r["rows"]) == _rows(e["rows"])
            assert r["keys"] == e["keys"]
    b, c = runs
    assert all(r["launches"] > 0 for r in b)
    assert all(r["dispatches"] == 0 and r["launches"] == 0 for r in c)


@pytest.mark.cuda
def test_card_placement_rule(cuda_device):
    """Sweep rows may share a card; a nodes row needs a card a rank."""
    cards = torch.cuda.device_count()
    multihost.check_ranks(2 * cards, "cuda", n_nodes=cards)
    with pytest.raises(RuntimeError, match="no fallback"):
        multihost.check_ranks(cards + 1, "cuda", n_nodes=cards + 1)


@pytest.fixture
def four_cards(cuda_device):
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards (NCCL nodes rows need a card a rank)")
    return cuda_device


@pytest.mark.cuda
def test_card_nccl_nodes_rows_equal_jax(four_cards, tmp_path):
    """A (2, 2) grid on four cards (each nodes row a NCCL group of two
    cards, the rows gathered over gloo) and a (1, 2) seed sweep equal the
    golden's JAX rows on every rank."""
    import test_torch_mesh_sweep as grid

    entries = json.loads(GOLDEN.read_text())["entries"]
    ranks = multihost.launch(grid.grid_job, 4, args=(2, ["pjit", "round", "hb"],
                                                     str(tmp_path)),
                             device="cuda", timeout_s=600, mesh_shape=(2, 2))
    for r in ranks:
        for name in ("pjit", "round", "hb"):
            rows, meta = r[name]
            assert _rows(rows) == _rows(entries[f"{name}@2x2"]["rows"]), name
    seeds = multihost.launch(grid.grid_job, 2, args=(1, ["seed"], str(tmp_path)),
                             device="cuda", timeout_s=600, mesh_shape=(1, 2))
    for r in seeds:
        assert _rows(r["seed"]) == _rows(entries["seed@2"]["run_sharded"])
