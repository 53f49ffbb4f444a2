"""First-divergence forensics over two probe series (port of
``blockchain_simulator_tpu/obsim/diverge.py``; numpy on the host).

Turns an opaque "bit-equality pin failed" into a located report: given
two probe pytrees (or plain ``{field: array}`` series dicts) from runs
that SHOULD agree — sharded vs single-device, resumed vs uninterrupted,
meshed vs plain, armed replay vs original — find the first sample index
where any field differs, and which field/lane it is.  Pure numpy on the
host (a torch leaf, on any device, is copied to the host first).

Series axis conventions (obsim/schema.py): the LAST axis is the sample
(window) axis; a leading axis, when present, is the committee/lane axis.
The report therefore names ``(sample, field, lane)``; the caller maps
sample -> tick via the run's sample unit (schema.sample_axis) — e.g. a
window boundary index maps through schema.window_bounds.
"""

from __future__ import annotations

import numpy as np

from blockchain_simulator_tpu_torch.obsim.schema import to_host


def _series_of(probes) -> dict:
    """Accept a probe pytree (``{"series": ..., "monitors": ...}``), a
    bare series dict, or a trace-style series dict (utils/trace.py runs
    carry a host-attached ``"t"`` axis — compared too: differing sample
    axes ARE a divergence)."""
    if isinstance(probes, dict) and "series" in probes \
            and isinstance(probes["series"], dict):
        return {k: to_host(v) for k, v in probes["series"].items()}
    return {k: to_host(v) for k, v in probes.items()}


def first_divergence(a, b) -> dict | None:
    """First divergent (sample, field[, lane]) between two probe series.

    Returns None when identical; otherwise a dict with the minimal
    divergent ``sample`` index (across all fields), the sorted ``fields``
    that diverge AT that sample, per-field ``lanes`` (leading-axis
    indices; empty for 1-D series), and per-field ``got``/``want`` values
    at the divergence point.  Raises on structural mismatch (different
    fields or shapes) — that is not a divergence, it is comparing
    different probe configs."""
    sa, sb = _series_of(a), _series_of(b)
    if sorted(sa) != sorted(sb):
        raise ValueError(
            f"probe structure mismatch: {sorted(sa)} vs {sorted(sb)}"
        )
    first: int | None = None
    detail: dict = {}
    for k in sorted(sa):
        va, vb = sa[k], sb[k]
        if va.shape != vb.shape:
            raise ValueError(
                f"probe shape mismatch on {k!r}: {va.shape} vs {vb.shape}"
            )
        neq = va != vb
        if not neq.any():
            continue
        # last axis = sample axis; collapse any leading lane axes
        per_sample = neq.reshape(-1, neq.shape[-1]).any(axis=0)
        s = int(np.flatnonzero(per_sample)[0])
        if first is None or s < first:
            first = s
        detail[k] = s
    if first is None:
        return None
    fields = sorted(k for k, s in detail.items() if s == first)
    out = {"sample": first, "fields": fields, "lanes": {}, "got": {},
           "want": {}}
    for k in fields:
        va, vb = sa[k], sb[k]
        col_a, col_b = va[..., first], vb[..., first]
        lanes = np.argwhere(np.atleast_1d(col_a != col_b))
        out["lanes"][k] = [tuple(int(i) for i in ix) for ix in lanes] \
            if va.ndim > 1 else []
        out["got"][k] = col_a.tolist() if va.ndim > 1 else int(col_a)
        out["want"][k] = col_b.tolist() if vb.ndim > 1 else int(col_b)
    return out


def render(div: dict | None, t_axis=None, unit: str = "sample") -> str:
    """Human-readable one-paragraph report of a :func:`first_divergence`
    result.  ``t_axis`` (e.g. schema.window_bounds output, or a trace
    series' ``"t"`` array) maps the sample index to the run's time axis
    when provided."""
    if div is None:
        return "no divergence: series identical"
    s = div["sample"]
    where = f"{unit} {s}"
    if t_axis is not None:
        where += f" (t={int(np.asarray(t_axis)[s])})"
    lines = [f"first divergence at {where}: "
             f"field(s) {', '.join(div['fields'])}"]
    for k in div["fields"]:
        lanes = div["lanes"][k]
        lane_s = f" lanes {lanes}" if lanes else ""
        lines.append(f"  {k}{lane_s}: got {div['got'][k]} "
                     f"want {div['want'][k]}")
    return "\n".join(lines)
