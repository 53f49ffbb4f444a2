"""The port's adaptive queries (``blockchain_simulator_tpu_torch/query``) held
to the JAX package, bit for bit.

The same query goes through the JAX package's ``query.run_query`` and the
port's on the CPU (``device="cpu"``); the answer, the trail (every step's
values, verdicts, bracket and journal keys) and the points (every row) must
be equal as canonical JSON.  The cases mirror ``tests/test_zzquery.py`` at
PBFT n = 16 on the round path (exact draws): the answer and its dispatch
accounting, the ``+q`` key namespace against grid keys, a journal written
by one package replayed by the other with 0 dispatches (both ways), a
``query.step`` chaos fault stopping a search that a second call resumes
(the completed steps answered from the journal), the ``min_k_finality``
kind, a served ``query`` request against the JAX server's answer (in
process and over HTTP), and ``"normal"`` lanes at n = 4,096 (where a
lane's draws follow the first lane's key, so the padded lane list must be
JAX's).  JAX's ``chaos/invariants.check_query_trail`` and
``check_sweep_journal`` run on the port's results and journals.

Golden file (the card's phases obsim-config4, query-config4 and obsim-tick
of ``chip_smoke.py``): ``blockchain_simulator_tpu_torch/golden/
obsim_query_s0.json``, written by the JAX package on the CPU with
``PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_query.py
--write-golden`` (~6 min: config 4's twelve probed lanes and the query's
16-lane steps at n = 100,000).
"""

from __future__ import annotations

import json
import pathlib
import sys
import tempfile

import jax
import pytest
import torch

from blockchain_simulator_tpu.chaos import invariants
from blockchain_simulator_tpu.models.base import canonical_fault_cfg as jcanon
from blockchain_simulator_tpu.obsim import host as jobs_host
from blockchain_simulator_tpu.obsim import schema as jobs_schema
from blockchain_simulator_tpu.parallel import journal as jjournal
from blockchain_simulator_tpu.parallel import sweep as jsweep
from blockchain_simulator_tpu.query import parse_query as jparse
from blockchain_simulator_tpu.query import run_query as jrun_query
from blockchain_simulator_tpu.utils.config import FaultConfig as JFault
from blockchain_simulator_tpu.utils.config import SimConfig as JConfig
from blockchain_simulator_tpu_torch.chaos import inject as tinject
from blockchain_simulator_tpu_torch.models.base import canonical_fault_cfg as tcanon
from blockchain_simulator_tpu_torch.parallel import journal as tjournal
from blockchain_simulator_tpu_torch.parallel import sweep as tsweep
from blockchain_simulator_tpu_torch.query import parse_query as tparse
from blockchain_simulator_tpu_torch.query import run_query as trun_query
from blockchain_simulator_tpu_torch.query import spec as tspec
from blockchain_simulator_tpu_torch.utils import obs
from blockchain_simulator_tpu_torch.utils.config import SimConfig as TConfig
from test_torch_pbft import release_jax_executables  # noqa: F401 (autouse fixture)

REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDEN_DIR = REPO / "blockchain_simulator_tpu_torch" / "golden"
GOLDEN = GOLDEN_DIR / "obsim_query_s0.json"
CONFIG4_GOLDEN = GOLDEN_DIR / "pbft_config4_n100k_s01.json"
EDGE_GOLDEN = GOLDEN_DIR / "pbft_edge_s0.json"
WRITTEN_BY = "PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_query.py --write-golden"

# the card's query: the largest Byzantine count config 4 survives, between
# its f = n/3 point (all 200 blocks) and its past-N/2 point (none)
QUERY4 = {"kind": "max_f_surviving", "param": "n_byzantine", "lo": 33333, "hi": 50001,
          "seeds": [0], "commit_target": 200, "probe_width": 16}
PROBE4 = {"windows": 16, "monitors": True}

# PBFT n = 16, 400 ms on the round path (lanes side by side, exact draws):
# all 7 blocks up to n_crashed = 5, none from 6 (the 2n/3 + 1 quorum)
QTPL = {"protocol": "pbft", "n": 16, "sim_ms": 400, "stat_sampler": "exact",
        "delivery": "stat", "schedule": "round", "model_serialization": False}
Q_MAXF = {"kind": "max_f_surviving", "seeds": [0, 1]}
# "normal" lanes: PBFT n = 4,096 on the round path (the sampler draws on
# Philox words that follow the first lane's key in a batch)
NORMAL = {"protocol": "pbft", "n": 4096, "sim_ms": 460, "delivery": "stat",
          "model_serialization": False, "pbft_max_rounds": 8, "pbft_max_slots": 16}
Q_NORMAL = {"kind": "cliff_locate", "param": "n_crashed", "lo": 0, "hi": 2100,
            "seeds": [0, 1], "commit_target": 8, "probe_width": 3}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU ops on one thread while this module runs: the suite runs
    several workers a machine, and torch's default of a thread a core each
    oversubscribes the cores many times over (the small ops here gain nothing
    from threads).  Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _canon(res) -> str:
    """The package-independent part of a query result as canonical JSON."""
    return obs.canonical_json({k: res[k] for k in ("query", "answer", "trail", "points")})


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """``jax_side(name)``: the JAX package's result of one query case, and
    the journal it wrote, computed once a process."""
    memo = {}
    root = tmp_path_factory.mktemp("jax_query")

    def get(name):
        if name not in memo:
            tpl, q = CASES[name]
            path = str(root / f"{name}.journal")
            memo[name] = (jrun_query(JConfig(**tpl), jparse(q),
                                     journal=jjournal.SweepJournal(path)), path)
        return memo[name]

    return get


CASES = {
    "maxf": (QTPL, Q_MAXF),
    "byz_width": (QTPL, {"kind": "cliff_locate", "param": "n_byzantine", "seeds": [0],
                         "probe_width": 3}),
    # overlay degree is program structure: one chunk a value, on the tick
    # engine (test_zzquery.py's n = 8 at 300 ms)
    "min_k": ({"protocol": "pbft", "n": 8, "sim_ms": 300, "stat_sampler": "exact"},
              {"kind": "min_k_finality", "seeds": [0], "lo": 6, "hi": 7}),
    "normal": (NORMAL, Q_NORMAL),
}


@pytest.mark.parametrize("name", list(CASES))
def test_query_equals_jax(name, jax_side, tmp_path):
    """Answer, trail and points equal JAX's; the port's journal holds JAX's
    chunk keys and row checksums line for line, and passes JAX's journal and
    trail invariants; the dispatch accounting is JAX's."""
    jres, jpath = jax_side(name)
    tpl, q = CASES[name]
    tpath = str(tmp_path / "port.journal")
    tres = trun_query(TConfig(**tpl), tparse(q), journal=tjournal.SweepJournal(tpath),
                      device="cpu")
    assert _canon(tres) == _canon(jres)
    assert tres["run"] == jres["run"]
    jl, tl = jjournal.SweepJournal(jpath).chunk_lines(), tjournal.SweepJournal(tpath).chunk_lines()
    assert [(r["key"], r["sums"], obs.canonical_json(r["rows"])) for r in tl] == \
        [(r["key"], r["sums"], obs.canonical_json(r["rows"])) for r in jl]
    assert invariants.check_sweep_journal(jjournal.SweepJournal(tpath)) == []
    assert invariants.check_query_trail(tres, journal=jjournal.SweepJournal(tpath)) == []


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_cross_package_replay_zero_dispatches(direction, jax_side, tmp_path):
    """A journal written by one package answers the other's identical query
    with 0 dispatches and the same answer, trail and points."""
    jres, jpath = jax_side("maxf")
    tpl, q = CASES["maxf"]
    if direction == "jax_to_port":
        again = trun_query(TConfig(**tpl), tparse(q), journal=tjournal.SweepJournal(jpath),
                           device="cpu")
    else:
        tpath = str(tmp_path / "port.journal")
        trun_query(TConfig(**tpl), tparse(q), journal=tjournal.SweepJournal(tpath),
                   device="cpu")
        again = jrun_query(JConfig(**tpl), jparse(q), journal=jjournal.SweepJournal(tpath))
    assert again["run"]["dispatches"] == 0
    assert again["run"]["cached_steps"] == again["run"]["steps"] == jres["run"]["steps"]
    assert _canon(again) == _canon(jres)


def test_chaos_step_fault_then_resume(jax_side, tmp_path):
    """A ``query.step`` fault at step 2 stops the first call (steps 0 and 1
    journaled); the second call serves them from the journal (``cached_steps``
    2) and computes every later step once; a third call replays with 0
    dispatches.  All three answers equal JAX's."""
    jres, _ = jax_side("maxf")
    tpl, q = CASES["maxf"]
    path = str(tmp_path / "chaos.journal")
    with tinject.ChaosController() as ctl:
        ctl.fail_next("query.step", n=1, match=lambda ctx: ctx.get("step") == 2)
        with pytest.raises(tinject.ChaosFault):
            trun_query(TConfig(**tpl), tparse(q), journal=tjournal.SweepJournal(path),
                       device="cpu")
    assert len(tjournal.SweepJournal(path).completed()) == 2
    resumed = trun_query(TConfig(**tpl), tparse(q), journal=tjournal.SweepJournal(path),
                         device="cpu")
    assert resumed["run"]["cached_steps"] == 2
    assert resumed["run"]["dispatches"] == resumed["run"]["steps"] - 2
    replay = trun_query(TConfig(**tpl), tparse(q), journal=tjournal.SweepJournal(path),
                        device="cpu")
    assert replay["run"]["dispatches"] == 0
    assert _canon(resumed) == _canon(replay) == _canon(jres)


def test_query_keys_disjoint_from_grid_and_probe_keys(tmp_path):
    """The ``+q<step>`` namespace: a grid chunk over a query step's content
    has the same content key without the suffix; query keys never carry the
    probe suffix; the key helpers equal JAX's."""
    tpl, q = CASES["maxf"]
    cfg = TConfig(**tpl)
    spec = tparse(q)
    qj = tjournal.SweepJournal(str(tmp_path / "q.journal"))
    trun_query(cfg, spec, journal=qj, device="cpu")
    lo, hi = tspec.resolve_domain(spec, cfg)
    pts = [(tspec.point_cfg(cfg, spec, v), s) for v in (lo, hi) for s in spec.seeds]
    gj = tjournal.SweepJournal(str(tmp_path / "g.journal"))
    tsweep.run_dyn_points(tcanon(pts[0][0]), pts, record=False, journal=gj, n_out=len(pts),
                          device="cpu")
    qkeys, gkeys = set(qj.completed()), set(gj.completed())
    assert qkeys and gkeys and not qkeys & gkeys
    assert all("+q" in k and "+p" not in k for k in qkeys)
    assert all("+" not in k for k in gkeys)
    assert next(k for k in qkeys if k.endswith("+q0"))[:-3] in gkeys
    jcfg = JConfig(**tpl)
    assert tjournal.query_chunk_key(tcanon(cfg), 3, [(cfg, 0)]) == \
        jjournal.query_chunk_key(jcanon(jcfg), 3, [(jcfg, 0)])


def test_serve_query_request_equals_jax_server(jax_side, tmp_path):
    """A served ``query`` request: the port's ScenarioServer answers JAX's
    server's answer, trail and query (the query worker thread, journaled);
    a second server on the same journal answers it with 0 dispatches; over
    HTTP the answer is a 200 (JAX's body, with no ``code`` key); a probe on a
    query, or an empty domain, is JAX's typed 400."""
    import json as _json
    import threading
    import urllib.request

    from blockchain_simulator_tpu.serve import ScenarioServer as JServer
    from blockchain_simulator_tpu.serve import schema as jsschema
    from blockchain_simulator_tpu_torch.serve import ScenarioServer as TServer
    from blockchain_simulator_tpu_torch.serve import schema as tsschema
    from blockchain_simulator_tpu_torch.serve.__main__ import make_httpd

    tpl, q = CASES["maxf"]
    req = dict(tpl, id="q", query=q)
    keys = ("query", "answer", "trail")
    jres, _ = jax_side("maxf")
    with JServer(journal_path=str(tmp_path / "j.journal")) as srv:
        jresp = srv.request(dict(req), wait_s=300)
    path = str(tmp_path / "t.journal")
    with TServer(journal_path=path, device="cpu") as srv:
        tresp = srv.request(dict(req), wait_s=300)
        assert srv.stats()["queries"] == 1
    assert tresp["status"] == jresp["status"] == "ok" and "code" not in tresp
    assert obs.canonical_json({k: tresp[k] for k in keys}) == \
        obs.canonical_json({k: jresp[k] for k in keys}) == \
        obs.canonical_json({k: jres[k] for k in keys})
    assert tresp["run"]["dispatches"] == jresp["run"]["dispatches"] > 0
    with TServer(journal_path=path, device="cpu") as srv:
        httpd = make_httpd(srv, "127.0.0.1", 0)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        http = urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/scenario",
            _json.dumps(req).encode()), timeout=300)
        again = _json.loads(http.read())
        httpd.shutdown()
    assert http.status == 200 and again["run"]["dispatches"] == 0
    assert obs.canonical_json({k: again[k] for k in keys}) == \
        obs.canonical_json({k: tresp[k] for k in keys})
    for bad in (dict(req, probe=True), dict(req, query=dict(q, lo=20))):
        with pytest.raises(tsschema.InvalidRequestError) as te:
            tsschema.parse_request(bad, "bad")
        with pytest.raises(jsschema.InvalidRequestError) as je:
            jsschema.parse_request(bad, "bad")
        assert (te.value.code, str(te.value)) == (je.value.code, str(je.value))


@pytest.mark.parametrize("bad", [
    {"kind": "nope"}, {"kind": "max_f_surviving", "param": "degree"},
    {"kind": "max_f_surviving", "seeds": []}, {"kind": "max_f_surviving", "probe_width": 65},
    {"kind": "max_f_surviving", "lo": 5, "hi": 2}, {"kind": "min_k_finality", "param": "n"},
    {"kind": "max_f_surviving", "extra": 1}, {"kind": "max_f_surviving", "commit_target": 0},
])
def test_parse_query_rejections_equal_jax(bad):
    """Spec validation: the same ``ValueError`` text as JAX's, and a good
    spec round-trips to JAX's dict."""
    with pytest.raises(ValueError) as te:
        tparse(bad)
    with pytest.raises(ValueError) as je:
        jparse(bad)
    assert str(te.value) == str(je.value)
    assert tparse(Q_NORMAL).to_dict() == jparse(Q_NORMAL).to_dict()


def test_golden_holds_the_card_configs():
    """The golden ``chip_smoke.py`` holds the card to: config 4's config and
    lane grid as the config-4 golden has them, config 2 as the edge golden
    has it, this file's query and probe config; JAX's own query invariants
    hold on its result, and every step's key is in the ``+q`` namespace."""
    doc = json.loads(GOLDEN.read_text())["entries"]
    cfg4, args = _config4()
    ob, q4, tick = doc["obsim_config4"], doc["query_config4"], doc["obsim_tick"]
    assert (ob["config"], ob["args"], ob["probe"]) == (cfg4, args, PROBE4)
    assert len(ob["rows"]) == len(args["f_values"]) * len(args["seeds"]) == len(ob["sums"])
    assert (q4["config"], q4["query"]) == (cfg4, QUERY4)
    assert invariants.check_query_trail(q4["result"]) == []
    assert all(k.endswith(f"+q{st['step']}") for st in q4["result"]["trail"]
               for k in st["keys"])
    edge = json.loads(EDGE_GOLDEN.read_text())["entries"]["n1000"]
    assert (tick["config"], tick["seed"], tick["metrics"]) == \
        (edge["config"], edge["seed"], edge["metrics"])


# ------------------------------------------------------------- golden ------

def _config4():
    """BASELINE config 4 (tools/run_config4.py:34-50 at n = 100,000) from
    the config-4 golden: its config, f values and seeds."""
    e = json.loads(CONFIG4_GOLDEN.read_text())["entries"]["config4"]
    return e["config"], e["args"]


def write_golden():
    """The JAX package's answers for the card's three phases."""
    cfg4_kw, args = _config4()
    cfg4 = JConfig(**cfg4_kw)
    pcfg = jobs_schema.ProbeConfig(**PROBE4)
    points = [(cfg4.with_(faults=JFault(n_byzantine=f, byz_forge=args["forge"])), s)
              for f in args["f_values"] for s in args["seeds"]]
    with tempfile.TemporaryDirectory() as d:
        j = jjournal.SweepJournal(f"{d}/obsim.journal")
        rows = jsweep.run_dyn_points(jcanon(cfg4), points, record=False, probe=pcfg, journal=j)
        (line,) = j.chunk_lines()
        print("obsim-config4 done", flush=True)
        qres = jrun_query(cfg4, jparse(QUERY4), journal=jjournal.SweepJournal(f"{d}/q.journal"))
        print(f"query-config4 done: {qres['answer']} {qres['run']}", flush=True)
    edge = json.loads(EDGE_GOLDEN.read_text())["entries"]["n1000"]
    tick_m, tick_s = jobs_host.run_probed(JConfig(**edge["config"]), edge["seed"], pcfg)
    doc = {
        "about": "JAX package (blockchain_simulator_tpu) results that the PyTorch port's "
                 "phases obsim-config4, query-config4 and obsim-tick must reproduce bit "
                 "for bit: config 4's twelve points through run_dyn_points(probe="
                 "ProbeConfig(windows=16, monitors=True), journal=) as one chunk (rows with "
                 "their probe summaries, the chunk key and row checksums); run_query on "
                 "config 4 (answer, trail, points, and JAX's dispatch accounting); BASELINE "
                 f"config 2 through obsim.host.run_probed. Written by: {WRITTEN_BY}",
        "entries": {
            "obsim_config4": {"config": cfg4_kw, "args": args, "probe": PROBE4,
                              "rows": rows, "key": line["key"], "sums": line["sums"]},
            "query_config4": {"config": cfg4_kw, "query": QUERY4,
                              "result": {k: qres[k] for k in ("query", "answer", "trail",
                                                              "points")},
                              "run": qres["run"]},
            "obsim_tick": {"config": edge["config"], "seed": edge["seed"], "probe": PROBE4,
                           "metrics": tick_m, "summary": tick_s},
        },
        "jax_version": jax.__version__,
    }
    GOLDEN.write_text(json.dumps(doc, indent=1, sort_keys=True) + "\n")
    print(f"wrote {GOLDEN}", flush=True)


if __name__ == "__main__":
    if sys.argv[1:] != ["--write-golden"]:
        sys.exit("usage: python tests/test_torch_query.py --write-golden")
    jax.config.update("jax_platforms", "cpu")
    write_golden()
