"""Where the tick engine's time goes on the card.

    python -m blockchain_simulator_tpu_torch.profile_tick

Runs the port's main path, the PBFT tick engine at n = 1000, sim_ms = 2500
(full mesh, edge delivery), on the CUDA card: the whole run plain, for its
wall time; then its first 1000 ticks plain and once more under
``torch.profiler`` (CUDA activity only: tracing every host op of a long run
costs minutes) for the device time by kernel.

Prints one JSON object: wall seconds and ticks/s of the run, and for the
window its wall, the device time of kernels and of memory copies apart, the
device's busy share, the kernels with the most device time, the ring-push
kernel's mean device time per launch (one launch a tick applies the tick's
four pushes), and the CUDA runtime calls the host makes most often.  The
busy share is the profiled window's device time over the wall of the same
window run without the profiler (the run is
deterministic, so both issue the same kernels; kernels run on one stream,
so they do not overlap).  ``profile_complete`` says whether the profile
holds every ring-push launch the wrapper counted, one per tick; a profile
that lost events is reported, not hidden.  Exits non-zero without a card.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

from blockchain_simulator_tpu_torch import runner
from blockchain_simulator_tpu_torch.ops import ring_kernel
from blockchain_simulator_tpu_torch.utils.config import SimConfig

MAIN_PATH = SimConfig(protocol="pbft", n=1000, sim_ms=2500)
WINDOW_MS = 1000


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _is_copy(evt) -> bool:
    return evt.key.startswith(("Memcpy", "Memset"))


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_tick: torch reports no CUDA device", file=sys.stderr)
        return 2
    cfg = MAIN_PATH
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip()
    runner.final_state(cfg.with_(sim_ms=60), device="cuda")  # build, cuBLAS init

    def timed(c):
        t0 = time.perf_counter()
        runner.final_state(c, device="cuda")
        return time.perf_counter() - t0

    wall = timed(cfg)
    win = cfg.with_(sim_ms=WINDOW_MS)
    wall_window = timed(win)
    ring_kernel.launches = ring_kernel.pushes = 0
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA],
                                acc_events=True) as prof:
        wall_profiled = timed(win)
    push_counted, pushes_counted = ring_kernel.launches, ring_kernel.pushes
    events = prof.key_averages()
    on_device = [e for e in events if _device_us(e) > 0]
    kernels = sorted((e for e in on_device if not _is_copy(e)), key=_device_us, reverse=True)
    copies = [e for e in on_device if _is_copy(e)]
    kernel_s = sum(_device_us(e) for e in kernels) / 1e6
    copy_s = sum(_device_us(e) for e in copies) / 1e6
    push = [e for e in kernels if "ring_push_group_kernel" in e.key]
    push_count = sum(e.count for e in push)
    runtime = sorted((e for e in events if e.key.startswith("cuda") and _device_us(e) == 0),
                     key=lambda e: e.count, reverse=True)
    print(json.dumps({
        "card": card,
        "config": {"protocol": "pbft", "n": cfg.n, "sim_ms": cfg.sim_ms,
                   "delivery": cfg.delivery, "edge_sampler": cfg.edge_sampler},
        "wall_s": wall,
        "ticks_per_s": cfg.ticks / wall,
        "window_ticks": win.ticks,
        "window_wall_s": wall_window,
        "window_wall_profiled_s": wall_profiled,
        "window_device_kernel_s": kernel_s,
        "window_device_copy_s": copy_s,
        "window_device_busy_share": (kernel_s + copy_s) / wall_window,
        "window_kernel_launches": sum(e.count for e in kernels),
        "window_kernel_launches_per_tick": sum(e.count for e in kernels) / win.ticks,
        "window_copies": sum(e.count for e in copies),
        "profile_complete": push_count == push_counted == win.ticks,
        "ring_push": {"launches_profiled": push_count,
                      "launches_counted": push_counted,
                      "pushes_counted": pushes_counted,
                      "device_us_per_launch": (sum(_device_us(e) for e in push) / push_count
                                               if push_count else None)},
        "top_kernels": [{"name": e.key[:90], "count": e.count,
                         "device_ms": _device_us(e) / 1e3} for e in kernels[:12]],
        "top_runtime_calls": [{"name": e.key, "count": e.count,
                               "host_ms": e.self_cpu_time_total / 1e3} for e in runtime[:8]],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
