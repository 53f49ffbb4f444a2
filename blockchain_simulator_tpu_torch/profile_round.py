"""Where the round-blocked PBFT fast path's time goes on the card.

    python -m blockchain_simulator_tpu_torch.profile_round

Runs the bench headline (``bench._cfg``: PBFT, n = 100,000, full mesh, stat
delivery, which ``schedule="auto"`` resolves to the round path with the
``"normal"`` sampler) on the CUDA card for its first 200 rounds: once plain,
for the wall time, and once more under ``torch.profiler`` (CUDA activity
only) for the device time by kernel.

Prints one JSON object: the window's wall and rounds/s, the device time of
kernels and of memory copies apart, the device's busy share (the profiled
device time over the wall of the same rounds run without the profiler; the
run is deterministic and on one stream, so both launch the same kernels and
none overlap), kernel launches and device-to-host copies per round, the
kernels with the most device time, and the CUDA runtime calls the host
makes most often.  Exits non-zero without a card.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

from blockchain_simulator_tpu_torch import runner
from blockchain_simulator_tpu_torch.models import pbft_round
from blockchain_simulator_tpu_torch.profile_tick import _device_us, _is_copy
from blockchain_simulator_tpu_torch.utils.config import SimConfig

WINDOW_ROUNDS = 200
# bench._cfg(WINDOW_ROUNDS): `rounds` rounds at 50 ms plus the commit tail
HEADLINE = SimConfig(protocol="pbft", n=100_000, sim_ms=WINDOW_ROUNDS * 50 + 100,
                     pbft_max_rounds=WINDOW_ROUNDS, pbft_max_slots=WINDOW_ROUNDS + 8,
                     pbft_window=8, delivery="stat", model_serialization=False)


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_round: torch reports no CUDA device", file=sys.stderr)
        return 2
    cfg = HEADLINE
    if not runner.use_round_schedule(cfg):
        raise AssertionError("the headline config should resolve to the round path")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip()
    runner.final_state(cfg.with_(sim_ms=300), device="cuda")  # warm-up

    def timed():
        t0 = time.perf_counter()
        final = runner.final_state(cfg, device="cuda")
        return time.perf_counter() - t0, final

    wall, final = timed()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA],
                                acc_events=True) as prof:
        wall_profiled, _ = timed()
    rounds = len(pbft_round.round_range(cfg))
    sent = runner.sim_metrics(cfg, final)["rounds_sent"]
    events = prof.key_averages()
    on_device = [e for e in events if _device_us(e) > 0]
    kernels = sorted((e for e in on_device if not _is_copy(e)), key=_device_us, reverse=True)
    copies = [e for e in on_device if _is_copy(e)]
    kernel_s = sum(_device_us(e) for e in kernels) / 1e6
    copy_s = sum(_device_us(e) for e in copies) / 1e6
    d2h = sum(e.count for e in copies if "DtoH" in e.key)
    runtime = sorted((e for e in events if e.key.startswith("cuda") and _device_us(e) == 0),
                     key=lambda e: e.count, reverse=True)
    print(json.dumps({
        "card": card,
        "config": {"protocol": "pbft", "n": cfg.n, "sim_ms": cfg.sim_ms,
                   "delivery": cfg.delivery, "stat_sampler": cfg.eff_stat_sampler,
                   "schedule": "round"},
        "window_rounds": rounds,
        "rounds_sent": sent,
        "wall_s": wall,
        "rounds_per_s": sent / wall,
        "wall_profiled_s": wall_profiled,
        "device_kernel_s": kernel_s,
        "device_copy_s": copy_s,
        "device_busy_share": (kernel_s + copy_s) / wall,
        "kernel_launches": sum(e.count for e in kernels),
        "kernel_launches_per_round": sum(e.count for e in kernels) / rounds,
        "copies_d2h": d2h,
        "copies_d2h_per_round": d2h / rounds,
        "copies": {e.key: e.count for e in copies},
        "top_kernels": [{"name": e.key[:90], "count": e.count,
                         "device_ms": _device_us(e) / 1e3} for e in kernels[:12]],
        "top_runtime_calls": [{"name": e.key, "count": e.count,
                               "host_ms": e.self_cpu_time_total / 1e3} for e in runtime[:8]],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
