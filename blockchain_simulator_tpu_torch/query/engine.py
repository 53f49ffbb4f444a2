"""The deterministic adaptive-search driver behind every query kind (port
of ``blockchain_simulator_tpu/query/engine.py``).

One algorithm answers all three specs (query/spec.py): a monotone *boundary
search* over an inclusive integer domain ``[lo, hi]``.  The domain splits
into a low side (where the predicate looks like it does at ``lo``) and a
high side (like at ``hi``); the search narrows the bracket between them
until it is one step wide.  For the fault kinds the predicate is monotone
*decreasing* (more crashed/Byzantine nodes never helps), for
``min_k_finality`` *increasing*; the same loop runs both by mapping each
point verdict onto low/high.

Every refinement **generation** batches into ONE
``parallel/sweep.run_dyn_points`` dispatch on the engine's device: the
probe values of a step share the canonical fault structure (fault counts
and seeds are run-time operands), and the probe list is padded by repeating
its last value, so every generation dispatches the SAME lane count, as in
the JAX package.  The padded lane list is JAX's exactly: under
``"normal"`` a lane's draws follow the first lane's key, so the rows are
JAX's only for JAX's lane list.  ``min_k_finality`` dispatches one chunk a
probed value (overlay degree is program structure).

**Durability** (``journal=``, a parallel/journal.SweepJournal): each
generation journals as one content-keyed chunk under the ``+q<step>``
namespace (journal.query_key_suffix), disjoint from grid and probe chunks
over the same canon, durable before the next generation dispatches.  The
search trajectory is deterministic, so a killed search re-derives the same
steps and serves every completed generation from the journal, and a pure
journal replay re-answers the query with 0 dispatches.  The keys are the
JAX package's, so either package replays the other's search.

Each generation fires the ``query.step`` chaos point, then runs inside a
``query.step`` telemetry span (a child of the ambient context: the server
parents it under the request's root span).
"""

from __future__ import annotations

from blockchain_simulator_tpu_torch.chaos import inject
from blockchain_simulator_tpu_torch.models.base import canonical_fault_cfg
from blockchain_simulator_tpu_torch.parallel import journal as journal_mod
from blockchain_simulator_tpu_torch.parallel import sweep
from blockchain_simulator_tpu_torch.query import spec as spec_mod
from blockchain_simulator_tpu_torch.utils import telemetry
from blockchain_simulator_tpu_torch.utils.config import SimConfig

# Kinds whose predicate is monotone increasing along the parameter.
_INCREASING = {"min_k_finality"}


def _probe_values(lt: int, ff: int, width: int) -> list[int]:
    """Up to ``width`` evenly spaced unique ints strictly inside
    ``(lt, ff)`` — never empty while ``ff - lt > 1``."""
    span = ff - lt
    k = min(width, span - 1)
    vals = {
        min(max(lt + round(span * j / (k + 1)), lt + 1), ff - 1)
        for j in range(1, k + 1)
    }
    return sorted(vals)


class _Search:
    """One query run's mutable state: memoized verdicts, the evaluation
    trail, and the dispatch accounting."""

    def __init__(self, cfg: SimConfig, spec: spec_mod.QuerySpec,
                 journal=None, mesh=None, multi_seed: bool = False, device=None):
        self.cfg = cfg
        self.spec = spec
        self.journal = journal
        self.mesh = mesh
        self.multi_seed = multi_seed
        self.device = device if mesh is None else mesh.device
        self.seeds = list(spec.seeds)
        # constant lanes per generation: the warmup step evaluates BOTH
        # endpoints, so every step dispatches max(probe_width, 2) values
        self.width = max(spec.probe_width, 2)
        self.verdicts: dict[int, bool] = {}
        self.trail: list[dict] = []
        self.points: list[dict] = []
        self.step = 0
        self.dispatches = 0
        self.lanes = 0
        self.pad = 0
        self.cached_steps = 0
        self.mono_violations = 0

    # -------------------------------------------------------- evaluation ---
    def _dispatch(self, values: list[int]):
        """ONE generation's dispatch: fault kinds batch every (value,
        seed) lane into one chunk; the degree kind dispatches one chunk
        per value (per-k structure)."""
        sfx = journal_mod.query_key_suffix(self.step)
        rows_by_value: dict[int, list[dict]] = {}
        metas = []
        if self.spec.param == "degree":
            for v in values:
                cfg_v = spec_mod.point_cfg(self.cfg, self.spec, v)
                canon_v = canonical_fault_cfg(cfg_v)
                pts = [(cfg_v, s) for s in self.seeds]
                rows, meta = sweep.run_dyn_points(
                    canon_v, pts, record=False, journal=self.journal,
                    multi_seed=self.multi_seed, key_suffix=sfx,
                    with_index=True, device=self.device)
                rows_by_value[v] = rows
                metas.append(meta)
        else:
            padded = list(values) + [values[-1]] * (self.width - len(values))
            pts = [(spec_mod.point_cfg(self.cfg, self.spec, v), s)
                   for v in padded for s in self.seeds]
            canon = canonical_fault_cfg(pts[0][0])
            rows, meta = sweep.run_dyn_points(
                canon, pts, record=False,
                n_out=len(values) * len(self.seeds),
                mesh=self.mesh, journal=self.journal,
                multi_seed=self.multi_seed, key_suffix=sfx,
                with_index=True, device=self.device)
            for i, v in enumerate(values):
                s0 = i * len(self.seeds)
                rows_by_value[v] = rows[s0:s0 + len(self.seeds)]
            metas.append(meta)
        return rows_by_value, metas

    def evaluate(self, values: list[int], bracket) -> None:
        """Evaluate one generation of unique, never-before-seen values;
        memoize verdicts, extend the trail."""
        inject.chaos_point("query.step", step=self.step, n=len(values),
                           values=list(values))
        with telemetry.span("query.step", step=self.step, n=len(values)):
            rows_by_value, metas = self._dispatch(values)
        fired = sum(m["dispatches"] for m in metas)
        self.dispatches += fired
        self.lanes += sum(m["lanes"] for m in metas)
        self.pad += sum(m["pad"] for m in metas)
        if fired == 0:
            self.cached_steps += 1
        gen_verdicts = []
        for v in values:
            ok = spec_mod.verdict(self.cfg.protocol, rows_by_value[v],
                                  self.spec)
            self.verdicts[v] = ok
            gen_verdicts.append([int(v), bool(ok)])
            for s, row in zip(self.seeds, rows_by_value[v]):
                self.points.append(
                    {"value": int(v), "seed": int(s), "metrics": row})
        self.trail.append({
            "step": self.step,
            "values": [int(v) for v in values],
            "verdicts": gen_verdicts,
            "bracket": list(bracket) if bracket else None,
            "keys": [c["key"] for m in metas for c in m["chunks"]],
        })
        self.step += 1

    def is_high(self, v: int) -> bool:
        ok = self.verdicts[v]
        return ok if self.spec.kind in _INCREASING else not ok


def run_query(cfg: SimConfig, spec: spec_mod.QuerySpec, journal=None,
              mesh=None, multi_seed: bool = False, device=None) -> dict:
    """Answer one query on ``device`` (the CUDA card when None):
    deterministic adaptive search over one registry entry's program.
    Returns ``{"query", "answer", "trail", "points", "run"}``; everything
    except ``"run"`` (this run's dispatch accounting: ``dispatches``,
    ``cached_steps``, ``steps``, ``lanes``, ``pad``,
    ``monotonicity_violations``) is equal across a fresh run, a
    kill-resume and a pure journal replay of the same query, and to the JAX
    package's answer.  ``mesh=`` (a parallel/mesh.make_mesh grid; call it
    on every rank) runs the fault kinds' generations over the mesh's sweep
    rows, as JAX's does (``min_k_finality``'s per-value chunks stay on one
    device, as JAX's do); every rank returns the answer."""
    lo, hi = spec_mod.resolve_domain(spec, cfg)
    st = _Search(cfg, spec, journal=journal, mesh=mesh, multi_seed=multi_seed,
                 device=device)
    # warmup generation: both endpoints
    st.evaluate([lo] if lo == hi else [lo, hi], None)
    if st.is_high(lo):
        low_max, high_min = None, lo       # boundary below the domain
    elif not st.is_high(hi):
        low_max, high_min = hi, None       # boundary above the domain
    else:
        lt, ff = lo, hi
        while ff - lt > 1:
            probes = _probe_values(lt, ff, st.width)
            st.evaluate(probes, (lt, ff))
            highs = [v for v in probes if st.is_high(v)]
            new_ff = min(highs) if highs else ff
            lows_ok = [v for v in probes if not st.is_high(v) and v < new_ff]
            # a low-side verdict ABOVE the new high boundary breaks the
            # monotone assumption — counted, resolved conservatively
            # toward the lower boundary
            st.mono_violations += sum(
                1 for v in probes if not st.is_high(v) and v >= new_ff)
            lt = max(lows_ok) if lows_ok else lt
            ff = new_ff
        low_max, high_min = lt, ff
    if spec.kind == "min_k_finality":
        answer = {"k_min": high_min, "last_failing": low_max}
    elif spec.kind == "max_f_surviving":
        answer = {"f_max": low_max, "first_failing": high_min}
    else:
        answer = {"last_true": low_max, "first_false": high_min}
    answer["param"] = spec.param
    answer["domain"] = [lo, hi]
    return {
        "query": spec.to_dict(),
        "answer": answer,
        "trail": st.trail,
        "points": st.points,
        "run": {
            "steps": st.step,
            "dispatches": st.dispatches,
            "cached_steps": st.cached_steps,
            "lanes": st.lanes,
            "pad": st.pad,
            "values_evaluated": len(st.verdicts),
            "monotonicity_violations": st.mono_violations,
        },
    }
