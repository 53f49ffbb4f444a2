"""The node-sharded engine beside the unsharded one on the card.

    python -m blockchain_simulator_tpu_torch.profile_shard

Joins a NCCL group of world size 1 (parallel/multihost.init_multihost: one
card, one rank) and runs, alone in this process, the two configurations of
``golden/shard_s0.json`` (config 2: PBFT, n = 1,000, 2,500 ms, edge tick;
the bench headline cut to 200 rounds: n = 100,000, the round path), each
unsharded (``runner.final_state``) and sharded
(``parallel/multihost.sharded_report``), in the order unsharded, sharded,
sharded, unsharded, after one short warm-up run of each.  Then it times a
gate's read by itself: a three-element int32 predicate read to the host
(``tolist``) as the unsharded tick does, the same read after the mesh's MAX
all-reduce as the sharded tick does, and the all-reduce alone, each
:data:`REPS` times in a row.

Prints one JSON object: the card's name and power limit, and for each
configuration every run's wall in order; a sharded run also its split
(``init_s``: the rank's rows of the init, ``body_s``: the run, ``gather_s``:
the final state all-gathered), its collectives and ring-push launches, and
whether its metrics and state digests equal the golden; and the gate
reads' microseconds each (``gate_us``).  Exits non-zero
without a card or when a sharded run differs from the golden.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import torch

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden" / "shard_s0.json"
RUNS = ("config2", "headline_200")
ORDER = ("unsharded", "sharded", "sharded", "unsharded")
REPS = 2000


def _gate_us(device) -> dict:
    """Microseconds a gate read costs, by itself, on a NCCL mesh of one."""
    from blockchain_simulator_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh()
    pred = torch.tensor([1, 0, 1], dtype=torch.int32, device=device)
    arms = {"read": lambda: pred.tolist(),
            "all_reduce_read": lambda: mesh.pmax(pred).tolist(),
            "all_reduce": lambda: mesh.pmax(pred)}
    out = {}
    for name, arm in arms.items():
        for _ in range(50):
            arm()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(REPS):
            arm()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) / REPS * 1e6
    return out


def _warm_kw(kw: dict) -> dict:
    """A short run of the same configuration (kernel builds, cuBLAS init)."""
    if kw.get("pbft_max_rounds"):
        return dict(kw, sim_ms=5 * 50 + 100, pbft_max_rounds=5)
    return dict(kw, sim_ms=60)


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_shard: torch reports no CUDA device", file=sys.stderr)
        return 2
    from blockchain_simulator_tpu_torch import runner
    from blockchain_simulator_tpu_torch.parallel import multihost
    from blockchain_simulator_tpu_torch.utils.config import SimConfig

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip()
    entries = json.loads(GOLDEN.read_text())["entries"]
    multihost.init_multihost(f"127.0.0.1:{multihost.free_port()}", 1, 0, "cuda")
    out = {"card": card, "order": list(ORDER), "configs": {}}
    ok = True
    try:
        for name in RUNS:
            want = entries[name]
            cfg = SimConfig(**want["config"])
            warm = SimConfig(**_warm_kw(want["config"]))
            runner.final_state(warm, device="cuda")
            multihost.sharded_report(warm)
            runs = []
            for kind in ORDER:
                if kind == "unsharded":
                    t0 = time.perf_counter()
                    runner.final_state(cfg, device="cuda")  # ends in force_sync
                    runs.append({"kind": kind, "wall_s": time.perf_counter() - t0})
                    continue
                rep = multihost.sharded_report(cfg)
                equal = (rep["metrics"] == want["metrics"]
                         and rep["state_sha256"] == want["state_sha256"])
                ok = ok and equal
                runs.append({"kind": kind, "wall_s": rep["wall_s"], "split_s": rep["split_s"],
                             "collectives": rep["collectives"], "launches": rep["launches"],
                             "equals_golden": equal})
            out["configs"][name] = {"config": want["config"], "runs": runs}
        out["gate_us"] = _gate_us("cuda")
    finally:
        multihost.shutdown()
    print(json.dumps(out), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
