"""The observability planes of the port against the JAX package's.

``alink_tpu_torch/common/{metrics,tracing,reqtrace,postmortem,adminz,
profiling2}.py`` are copies of the JAX package's modules (the admin
plane without ``/compilez``, ``profiling2`` its host half). Each case
below drives one scenario through BOTH packages with the same inputs
and holds the port's result equal to the JAX package's: registry
snapshots, JSONL run reports (apart from their wall-clock stamps) and
Prometheus text; chrome-trace events apart from timestamps and thread
ids; ring bounds and drop counts; request timelines' shapes;
post-mortem bundles' sections; the admin plane's answers; the profile
collector's attribution. Each case also checks the property itself on
the port's side, so an equality of two wrong answers still fails.
"""

import json
import os
import threading
import time
import urllib.request
import warnings
from types import SimpleNamespace

import pytest

import alink_tpu.common.adminz as j_adminz
import alink_tpu.common.metrics as j_metrics
import alink_tpu.common.postmortem as j_postmortem
import alink_tpu.common.profiling2 as j_profiling2
import alink_tpu.common.reqtrace as j_reqtrace
import alink_tpu.common.tracing as j_tracing
import alink_tpu_torch.common.adminz as t_adminz
import alink_tpu_torch.common.metrics as t_metrics
import alink_tpu_torch.common.postmortem as t_postmortem
import alink_tpu_torch.common.profiling2 as t_profiling2
import alink_tpu_torch.common.reqtrace as t_reqtrace
import alink_tpu_torch.common.tracing as t_tracing

J = SimpleNamespace(metrics=j_metrics, tracing=j_tracing, reqtrace=j_reqtrace,
                    postmortem=j_postmortem, adminz=j_adminz,
                    profiling2=j_profiling2)
T = SimpleNamespace(metrics=t_metrics, tracing=t_tracing, reqtrace=t_reqtrace,
                    postmortem=t_postmortem, adminz=t_adminz,
                    profiling2=t_profiling2)

_STAMPS = ("created_unix", "dumped_unix", "exported_unix", "origin_unix")


def _both(scenario, *args):
    """The scenario's result in the JAX package and in the port."""
    return scenario(J, *args), scenario(T, *args)


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    """Fresh registries, tracers and request rings in both packages."""
    for k in ("ALINK_TPU_METRICS", "ALINK_TPU_TRACE", "ALINK_TPU_REQTRACE",
              "ALINK_TPU_REQTRACE_RING", "ALINK_TPU_POSTMORTEM_DIR",
              "ALINK_TPU_PROFILE", "ALINK_TPU_ADMIN_PORT"):
        monkeypatch.delenv(k, raising=False)
    saved = []
    for ns in (J, T):
        saved.append((ns, ns.metrics.set_registry(ns.metrics.MetricsRegistry()),
                      ns.tracing.set_tracer(ns.tracing.Tracer(capacity=4096))))
        ns.reqtrace.reset()
        ns.postmortem.reset_debounce()
        ns.postmortem.clear_context()
    yield
    for ns, reg, tr in saved:
        ns.metrics.set_registry(reg)
        ns.tracing.set_tracer(tr)
        ns.reqtrace.reset()
        ns.postmortem.reset_debounce()


def _strip(doc):
    """A JSON document without its wall-clock stamps."""
    if isinstance(doc, dict):
        return {k: _strip(v) for k, v in doc.items() if k not in _STAMPS}
    if isinstance(doc, list):
        return [_strip(v) for v in doc]
    return doc


# -- metrics ------------------------------------------------------------------

def _record(reg):
    reg.inc("requests_total", 1, {"route": "/fit"})
    reg.inc("requests_total", 2.5, {"route": "/fit"})
    reg.inc("requests_total", 1, {"route": "/pre\"dict\n"})
    reg.set_gauge("queue_depth", 3)
    reg.set_gauge("queue_depth", 7)
    for v in (0.0004, 0.003, 0.003, 0.2, 99.0):
        reg.observe("latency_seconds", v, {"op": "serve"},
                    exemplar={"trace_id": f"r{int(v * 1e4)}"})
    reg.observe("sizes", 5.0, buckets=(1.0, 10.0))
    reg.counter("helped_total", "a counter with help").inc(4)


def _m_snapshot_and_text(ns):
    reg = ns.metrics.MetricsRegistry()
    _record(reg)
    return reg.snapshot(), reg.render_text(), reg.value("queue_depth"), \
        reg.value("missing_total")


def _m_jsonl(ns, tmp):
    reg = ns.metrics.MetricsRegistry()
    _record(reg)
    path = reg.dump(os.path.join(tmp, f"{ns.metrics.__name__}.jsonl"))
    with open(path) as f:
        lines = [_strip(json.loads(ln)) for ln in f]
    back = ns.metrics.MetricsRegistry.load(path)
    return lines, back.snapshot() == reg.snapshot()


def _m_cardinality(ns):
    reg = ns.metrics.MetricsRegistry(max_series_per_metric=3)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for i in range(7):
            reg.inc("ids_total", 1, {"id": i})
    return (reg.snapshot(), reg._dropped_series,
            sum("cardinality cap" in str(w.message) for w in caught))


def _m_errors(ns):
    reg = ns.metrics.MetricsRegistry()
    reg.inc("c_total")
    out = []
    for call in (lambda: reg.set_gauge("c_total", 1),
                 lambda: reg.inc("c_total", -1),
                 lambda: reg.histogram("h", buckets=(2.0, 1.0)),
                 lambda: reg.observe("c_total", 1.0),
                 lambda: reg.histogram("h2", buckets=(1.0,)) and
                 reg.histogram("h2", buckets=(2.0,)),
                 lambda: reg.histogram("h3").value()):
        try:
            call()
            out.append(None)
        except (TypeError, ValueError) as e:
            out.append(type(e).__name__)
    return out


def _m_torn_tail(ns, tmp):
    reg = ns.metrics.MetricsRegistry()
    _record(reg)
    path = reg.dump(os.path.join(tmp, f"torn-{ns.metrics.__name__}.jsonl"))
    with open(path) as f:
        text = f.read()
    with open(path, "w") as f:
        f.write(text[:-25])                 # a dump killed mid-write
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        back = ns.metrics.MetricsRegistry.load(path)
    with open(path, "w") as f:
        lines = text.splitlines()
        f.write("\n".join(lines[:2] + ["{not json"] + lines[2:]) + "\n")
    try:
        ns.metrics.MetricsRegistry.load(path)
        mid = None
    except ValueError:
        mid = "ValueError"
    return back.snapshot(), len(caught), mid


def _m_fallback_once(ns):
    reg = ns.metrics.get_registry()
    ns.metrics.reset_fallback_warnings()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fired = [ns.metrics.record_fallback_once(
            "unit", "fb_total", {"reason": r}, f"fallback {r}")
            for r in ("a", "a", "b", "a")]
        ns.metrics.reset_fallback_warnings("unit")
        again = ns.metrics.record_fallback_once("unit", "fb_total",
                                                {"reason": "a"}, "again")
    return fired, again, [str(w.message) for w in caught], reg.snapshot()


def _m_enabled(ns, monkeypatch):
    out = [ns.metrics.metrics_enabled()]
    for raw in ("0", "false", "OFF", "no", "", "1", "yes"):
        monkeypatch.setenv("ALINK_TPU_METRICS", raw)
        out.append(ns.metrics.metrics_enabled())
    monkeypatch.delenv("ALINK_TPU_METRICS")
    return out


def test_metrics_snapshot_and_prometheus_text_equal():
    jax_side, port = _both(_m_snapshot_and_text)
    assert port == jax_side
    snap, text, depth, missing = port
    assert depth == 7.0 and missing == 0.0
    assert 'requests_total{route="/fit"} 3.5' in text
    assert 'route="/pre\\"dict\\n"' in text
    hist = next(r for r in snap if r["name"] == "latency_seconds")
    assert hist["count"] == 5 and hist["counts"][-1] == 1
    assert hist["exemplars"][-1]["trace_id"] == "r990000"


def test_metrics_jsonl_run_report_equal(tmp_path):
    jax_side, port = _both(_m_jsonl, str(tmp_path))
    assert port == jax_side
    lines, round_trip = port
    assert lines[0]["format"] == "alink_tpu_metrics_v1" and round_trip


def test_metrics_cardinality_cap_folds_like_the_jax_package():
    jax_side, port = _both(_m_cardinality)
    assert port == jax_side
    snap, dropped, warned = port
    assert len(snap) == 4 and dropped == 4 and warned == 1
    assert {"alink_overflow": "true"} in [r["labels"] for r in snap]


def test_metrics_refusals_equal():
    jax_side, port = _both(_m_errors)
    assert port == jax_side
    assert port == ["TypeError", "ValueError", "ValueError", "TypeError",
                    "ValueError", "TypeError"]


def test_metrics_torn_tail_loads_like_the_jax_package(tmp_path):
    jax_side, port = _both(_m_torn_tail, str(tmp_path))
    assert port == jax_side
    assert port[1] == 1 and port[2] == "ValueError"


def test_record_fallback_once_equal():
    jax_side, port = _both(_m_fallback_once)
    assert port == jax_side
    fired, again, messages, snap = port
    assert fired == [True, False, True, False] and again is True
    assert len(messages) == 3
    assert sum(r["value"] for r in snap if r["name"] == "fb_total") == 5


def test_metrics_switch_parses_like_the_jax_package(monkeypatch):
    jax_side, port = _both(_m_enabled, monkeypatch)
    assert port == jax_side
    assert port == [True, False, False, False, False, False, True, True]


# -- tracing ------------------------------------------------------------------

def _events(doc):
    """Chrome events without timestamps, durations and thread ids."""
    out = []
    for e in doc["traceEvents"]:
        e = {k: v for k, v in e.items() if k not in ("ts", "dur", "tid")}
        if e.get("name") == "thread_name":
            e["args"] = {"name": "<thread>"}
        out.append(e)
    return out


def _t_tree(ns):
    tr = ns.tracing.Tracer(capacity=64)
    with tr.span("exec", cat="engine", args={"n": 1}) as s:
        with tr.span("prepare"):
            tr.instant("cache", args={"result": "hit"})
        s.set(status="ok")
        tr.complete("retro", 0.002, cat="stream")
    try:
        with tr.span("boom"):
            raise KeyError("x")
    except KeyError:
        pass
    tr.instant("after")
    doc = tr.to_chrome()
    return _events(doc), _strip(doc["otherData"]) | {"threads": None}


def _t_ring(ns):
    tr = ns.tracing.Tracer(capacity=5)
    for i in range(12):
        tr.instant(f"e{i}")
    return [e["name"] for e in tr.events()], tr.dropped, tr.capacity


def _t_threads(ns):
    tr = ns.tracing.Tracer(capacity=256)
    # the threads overlap, so none reuses a finished one's ident
    start, stop = threading.Barrier(3), threading.Barrier(3)

    def work(k):
        start.wait(30)
        for i in range(5):
            with tr.span(f"w{k}"):
                tr.instant(f"i{k}.{i}")
        stop.wait(30)
    ths = [threading.Thread(target=work, args=(k,)) for k in range(3)]
    for th in ths:
        th.start()
    for th in ths:
        th.join(30)
    evs = tr.events()
    lanes = {}
    for e in evs:
        lanes.setdefault(e["tid"], set()).add(e["name"][1])
    # each thread's spans and instants stay in one lane of their own
    return (sorted(tuple(sorted(v)) for v in lanes.values()), len(evs),
            tr.dropped, not any(th.is_alive() for th in ths))


def _t_gate(ns, monkeypatch):
    tr = ns.tracing.get_tracer()
    out = []
    for raw in (None, "0", "1"):
        if raw is None:
            monkeypatch.delenv("ALINK_TPU_TRACE", raising=False)
        else:
            monkeypatch.setenv("ALINK_TPU_TRACE", raw)
        tr.clear()
        with ns.tracing.trace_span("s", args={"a": 1}) as sp:
            sp.set(b=2)
            ns.tracing.trace_instant("i")
        ns.tracing.trace_complete("c", 0.001)
        out.append((ns.tracing.tracing_enabled(),
                    sorted((e["name"], e.get("args") or {})
                           for e in tr.events())))
    monkeypatch.delenv("ALINK_TPU_TRACE")
    return out


def _t_capacity_flag(ns, monkeypatch):
    out = []
    for raw in ("", "17", "0", "junk"):
        monkeypatch.setenv("ALINK_TPU_TRACE_BUFFER", raw)
        out.append(ns.tracing.Tracer().capacity)
    monkeypatch.delenv("ALINK_TPU_TRACE_BUFFER")
    return out


def _t_jsonl(ns, tmp):
    tr = ns.tracing.Tracer(capacity=8)
    with tr.span("a"):
        tr.instant("b")
    path = tr.export_jsonl(os.path.join(tmp, f"{ns.tracing.__name__}.jsonl"))
    chrome = tr.export_chrome(os.path.join(tmp, f"{ns.tracing.__name__}.json"))
    with open(path) as f:
        lines = [json.loads(ln) for ln in f]
    with open(chrome) as f:
        doc = json.load(f)
    lines[0] = _strip(lines[0]) | {"threads": None}
    for e in lines[1:]:
        for k in ("ts", "dur", "tid"):
            e.pop(k, None)
    return lines, _events(doc)


def test_trace_span_tree_equal():
    jax_side, port = _both(_t_tree)
    assert port == jax_side
    events, other = port
    names = [e["name"] for e in events]
    assert names[:2] == ["process_name", "thread_name"]
    assert other["format"] == "alink_tpu_trace_v1"
    by = {e["name"]: e for e in events}
    assert by["prepare"]["args"]["parent_id"] == by["exec"]["args"]["span_id"]
    assert by["cache"]["args"]["parent_id"] == by["prepare"]["args"]["span_id"]
    assert by["exec"]["args"]["status"] == "ok"
    assert by["cache"]["s"] == "t" and "boom" in by


def test_trace_ring_bound_and_drops_equal():
    jax_side, port = _both(_t_ring)
    assert port == jax_side
    assert port == (["e7", "e8", "e9", "e10", "e11"], 7, 5)


def test_trace_threads_are_separate_lanes_equal():
    jax_side, port = _both(_t_threads)
    assert port == jax_side
    assert port == ([("0",), ("1",), ("2",)], 30, 0, True)


def test_trace_switch_gates_recording_equal(monkeypatch):
    jax_side, port = _both(_t_gate, monkeypatch)
    assert port == jax_side
    assert port[0] == (False, []) and port[1] == (False, [])
    assert port[2] == (True, [("c", {}), ("i", {}),
                              ("s", {"a": 1, "b": 2})])


def test_trace_buffer_flag_equal(monkeypatch):
    jax_side, port = _both(_t_capacity_flag, monkeypatch)
    assert port == jax_side
    assert port == [65536, 17, 1, 65536]


def test_trace_exports_equal(tmp_path):
    jax_side, port = _both(_t_jsonl, str(tmp_path))
    assert port == jax_side
    lines, events = port
    assert lines[0]["kind"] == "meta" and len(lines) == 3
    assert [e["name"] for e in events][-2:] in (["a", "b"], ["b", "a"])


# -- request tracing ----------------------------------------------------------

def _r_phases(ns):
    ctx = ns.reqtrace.RequestContext("r1", tenant="acme")
    for m in ("dequeue", "coalesce", "dispatch", "device", "decode"):
        ctx.mark(m)
    for i in range(ns.reqtrace.MAX_ANNOTATIONS + 5):
        ctx.annotate("swap", {"version": i})
    doc = ctx.to_doc(total_s=ctx.elapsed_s())
    ts = [m["t_s"] for m in doc["marks"]]
    return ([m["phase"] for m in doc["marks"]], sorted(doc["phases"]),
            doc["tenant"], doc["dropped_annotations"],
            len(doc["annotations"]), ts == sorted(ts) and ts[0] == 0.0,
            ctx.phase_end("nope"))


def _r_ring(ns, monkeypatch):
    monkeypatch.setenv("ALINK_TPU_REQTRACE_RING", "4")
    ids = []
    for _ in range(10):
        ctx = ns.reqtrace.admit()
        ids.append(ctx.trace_id)
        ns.reqtrace.finish(ctx, outcome="ok")
    docs = ns.reqtrace.recent()
    got = ([d["trace_id"] for d in docs] == ids[-1:-5:-1],
           len(docs), ns.reqtrace.find(ids[0]) is None,
           ns.reqtrace.find(ids[-1])["outcome"],
           len(ns.reqtrace.recent(n=2)))
    monkeypatch.delenv("ALINK_TPU_REQTRACE_RING")
    return got


def _r_inflight(ns, monkeypatch):
    live = ns.reqtrace.admit(tenant="a")
    done = ns.reqtrace.admit(tenant="b")
    ns.reqtrace.finish(done)
    n = ns.reqtrace.annotate_inflight("swap", {"version": 3})
    with ns.reqtrace.batch_scope([live, None]):
        ns.reqtrace.batch_mark("dispatch")
    ns.reqtrace.batch_mark("outside")            # no scope: a no-op
    inflight = ns.reqtrace.inflight_docs()
    monkeypatch.setenv("ALINK_TPU_REQTRACE", "0")
    off = (ns.reqtrace.admit(), ns.reqtrace.finish(None))
    monkeypatch.delenv("ALINK_TPU_REQTRACE")
    return (n, [a["kind"] for a in live.annotations],
            [m for m, _ in live.marks],
            ns.reqtrace.find(done.trace_id)["annotations"],
            [e["kind"] for e in ns.reqtrace.recent_events()],
            len(inflight), off, len(ns.reqtrace.recent(tenant="b")))


def _r_exemplar(ns):
    recs = [{"buckets": [0.1, 1.0], "counts": [10, 0, 1],
             "exemplars": [{"trace_id": "rA"}, None, None]},
            {"buckets": [0.1, 1.0], "counts": [1, 50, 0],
             "exemplars": [None, {"trace_id": "rB"}, None]},
            {"buckets": [], "counts": [], "exemplars": []},
            {"buckets": [0.1], "counts": [3, 0], "exemplars": [None, None]}]
    return [ns.reqtrace.p99_exemplar(r) for r in recs]


def test_request_timeline_phases_equal():
    jax_side, port = _both(_r_phases)
    assert port == jax_side
    assert port[0] == ["admit", "dequeue", "coalesce", "dispatch",
                       "device", "decode"]
    assert port[1] == ["coalesce_s", "decode_s", "device_s", "dispatch_s",
                       "queue_s"]
    assert port[3] == 5 and port[4] == 16 and port[5] is True


def test_request_ring_bound_equal(monkeypatch):
    jax_side, port = _both(_r_ring, monkeypatch)
    assert port == jax_side
    assert port == (True, 4, True, "ok", 2)


def test_request_overlap_annotations_equal(monkeypatch):
    jax_side, port = _both(_r_inflight, monkeypatch)
    assert port == jax_side
    assert port[0] == 1 and port[1] == ["swap"]
    assert port[2] == ["admit", "dispatch"] and port[3] == []
    assert port[6] == (None, None) and port[7] == 1


def test_p99_exemplar_resolution_equal():
    jax_side, port = _both(_r_exemplar)
    assert port == jax_side
    assert port == [{"trace_id": "rA"}, {"trace_id": "rB"}, None, None]


# -- post-mortem bundles ------------------------------------------------------

def _p_bundle(ns, tmp, monkeypatch):
    d = os.path.join(tmp, ns.postmortem.__name__)
    monkeypatch.setenv("ALINK_TPU_POSTMORTEM_DIR", d)
    monkeypatch.setenv("ALINK_TPU_TRACE", "1")
    ns.metrics.get_registry().inc("unit_total", 2)
    ctx = ns.reqtrace.admit()
    ctx.mark("dequeue")
    ns.reqtrace.finish(ctx)
    ns.reqtrace.annotate_inflight("breaker", {"to": "open"})
    ns.postmortem.set_context("checkpoint", "/ckpt/42")
    path = ns.postmortem.maybe_bundle("breaker_open", "unit trigger",
                                      extra={"step": 2, "obj": object()})
    cascade = ns.postmortem.maybe_bundle("slo_burn", "cascade")
    doc = ns.postmortem.load_bundle(path)
    monkeypatch.delenv("ALINK_TPU_TRACE")
    files = os.listdir(d)
    suppressed = ns.metrics.get_registry().value(
        "alink_postmortem_suppressed_total", {"reason": "slo_burn"})
    return (sorted(doc), doc["format"], doc["reason"], doc["detail"],
            doc["extra"]["step"], doc["extra"]["obj"].startswith("<object"),
            doc["context"], len(doc["requests"]), len(doc["inflight"]),
            [e["kind"] for e in doc["events"]],
            [r["name"] for r in doc["metrics"]],
            doc["flags"]["ALINK_TPU_POSTMORTEM_KEEP"],
            doc["statusz"], cascade, len(files), suppressed,
            [e["name"] for e in doc["trace"]["events"]])


def _p_retention(ns, tmp, monkeypatch):
    d = os.path.join(tmp, "ret-" + ns.postmortem.__name__)
    monkeypatch.setenv("ALINK_TPU_POSTMORTEM_DIR", d)
    monkeypatch.setenv("ALINK_TPU_POSTMORTEM_DEBOUNCE_S", "0")
    monkeypatch.setenv("ALINK_TPU_POSTMORTEM_KEEP", "2")
    paths = []
    for i in range(4):
        paths.append(ns.postmortem.maybe_bundle(f"r{i}"))
        time.sleep(0.01)
    left = sorted(os.listdir(d))
    monkeypatch.delenv("ALINK_TPU_POSTMORTEM_DIR")
    unarmed = ns.postmortem.maybe_bundle("breaker_open")
    try:
        bad = os.path.join(d, "bad.json")
        with open(bad, "w") as f:
            json.dump({"format": "other"}, f)
        ns.postmortem.load_bundle(bad)
        refused = None
    except ValueError:
        refused = "ValueError"
    return (all(paths), len(left), os.path.basename(paths[-1]) in left,
            unarmed, refused)


def test_postmortem_bundle_sections_equal(tmp_path, monkeypatch):
    jax_side, port = _both(_p_bundle, str(tmp_path), monkeypatch)
    assert port == jax_side
    assert port[1] == "alink_tpu_postmortem_v1" and port[2] == "breaker_open"
    assert port[6] == {"checkpoint": "/ckpt/42"} and port[7] == 1
    assert port[9] == ["breaker"] and port[11] == 8
    assert port[12] == {"armed": False}
    assert port[13] is None and port[14] == 1 and port[15] == 1.0
    assert "postmortem.bundle" not in port[16]       # written after capture


def test_postmortem_retention_and_debounce_equal(tmp_path, monkeypatch):
    jax_side, port = _both(_p_retention, str(tmp_path), monkeypatch)
    assert port == jax_side
    assert port == (True, 2, True, None, "ValueError")


def test_postmortem_flags_are_the_ports_registry(tmp_path, monkeypatch):
    """The port's bundle resolves the port's own registry: every flag
    the port declares, no flag it does not."""
    from alink_tpu_torch.common.flags import FLAGS
    monkeypatch.setenv("ALINK_TPU_POSTMORTEM_DIR", str(tmp_path))
    monkeypatch.setenv("ALINK_TPU_SERVE_DTYPE", "int4")     # unparsable
    doc = t_postmortem.load_bundle(t_postmortem.maybe_bundle("unit"))
    assert sorted(doc["flags"]) == FLAGS.names()
    assert doc["flags"]["ALINK_TPU_SERVE_DTYPE"] == {
        "raw": "int4", "error": "unparsable"}


# -- the admin plane ------------------------------------------------------------

def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _a_endpoints(ns):
    ns.metrics.get_registry().inc("alink_unit_total", 3, {"k": "v"})
    ctx = ns.reqtrace.admit()
    ns.reqtrace.finish(ctx)
    srv = ns.adminz.AdminServer(port=0, host="127.0.0.1", name="unit").start()
    try:
        out = {}
        out["metrics"] = _get(srv.url + "/metrics")
        code, body = _get(srv.url + "/varz")
        # the plane's own series carry its port and scrape times
        out["varz"] = (code, [r for r in _strip(json.loads(body))
                              if not r.get("name", "").startswith(
                                  "alink_admin_")])
        out["healthz0"] = _get(srv.url + "/healthz")
        srv.add_source("a", lambda: {"ready": True})
        srv.add_source("b", lambda: {"ready": True, "healthy": False,
                                     "why": "breaker"})
        out["healthz"] = _get(srv.url + "/healthz")
        out["readyz"] = _get(srv.url + "/readyz")

        def crash():
            raise RuntimeError("probe died")
        srv.add_source("b", crash)
        out["crash"] = _get(srv.url + "/readyz")
        srv.remove_source("b")
        out["readyz2"] = _get(srv.url + "/readyz")
        srv.add_status("sec", lambda: {"x": (1, 2), "o": object})
        code, body = _get(srv.url + "/statusz")
        st = json.loads(body)
        out["statusz"] = (code, st["sections"], st["name"],
                          st["flags"]["ALINK_TPU_ADMIN_TRACEZ"])
        code, body = _get(srv.url + "/requestz?n=5")
        rq = json.loads(body)
        out["requestz"] = (code, rq["enabled"], rq["returned"],
                           [sorted(d) for d in rq["requests"]])
        out["missing"] = _get(srv.url + "/nope")[0]
        out["scrapes"] = ns.metrics.get_registry().value(
            "alink_admin_requests_total", {"path": "/metrics", "code": 200})
    finally:
        srv.close()
    return out


def _a_tracez(ns, monkeypatch):
    monkeypatch.setenv("ALINK_TPU_ADMIN_TRACEZ", "3")
    tr = ns.tracing.get_tracer()
    for i in range(6):
        tr.instant(f"e{i}", args={"trace_id": "rX" if i % 2 else "rY"})
    srv = ns.adminz.AdminServer(port=0, host="127.0.0.1").start()
    try:
        docs = []
        for q in ("", "?n=2", "?n=99", "?trace_id=rX", "?n=junk"):
            code, body = _get(srv.url + "/tracez" + q)
            d = json.loads(body)
            docs.append((code, d["returned"], d["total_buffered"],
                         [e["name"] for e in d["events"]]))
    finally:
        srv.close()
    monkeypatch.delenv("ALINK_TPU_ADMIN_TRACEZ")
    return docs


def _a_shared(ns, monkeypatch):
    monkeypatch.delenv("ALINK_TPU_ADMIN_PORT", raising=False)
    off = ns.adminz.acquire_admin("x")
    monkeypatch.setenv("ALINK_TPU_ADMIN_PORT", "-1")
    monkeypatch.setenv("ALINK_TPU_ADMIN_HOST", "127.0.0.1")
    a = ns.adminz.acquire_admin("x")
    b = ns.adminz.acquire_admin("y")
    same = a is b and ns.adminz.get_admin() is a
    code = _get(a.url + "/healthz")[0]
    ns.adminz.release_admin()
    still = ns.adminz.get_admin() is a
    ns.adminz.release_admin()
    gone = ns.adminz.get_admin()
    monkeypatch.delenv("ALINK_TPU_ADMIN_PORT")
    return off, same, code, still, gone


def test_admin_endpoints_answer_like_the_jax_package():
    jax_side, port = _both(_a_endpoints)
    jax_side["metrics"] = (jax_side["metrics"][0], None)
    metrics = port.pop("metrics")
    jax_side.pop("metrics")
    assert port == jax_side
    assert metrics[0] == 200 and 'alink_unit_total{k="v"} 3.0' in metrics[1]
    assert port["healthz0"][0] == 200
    assert port["healthz"][0] == 503 and port["readyz"][0] == 200
    assert port["crash"][0] == 503 and "probe died" in port["crash"][1]
    assert port["readyz2"][0] == 200 and port["missing"] == 404
    assert port["statusz"] == (200, {"sec": {"x": [1, 2],
                                             "o": "<class 'object'>"}},
                               "unit",
                               {"kind": "int", "value": 512,
                                "default": 512, "set": False,
                                "section": "observability"})
    assert port["requestz"][:3] == (200, True, 1)


def test_admin_metrics_text_is_the_registry_text():
    """``/metrics`` serves ``render_text()`` as it was when scraped: the
    same text in both packages, apart from the admin plane's own scrape
    series (recorded after each answer)."""
    for ns in (J, T):
        ns.metrics.get_registry().inc("alink_unit_total", 1)
    texts = []
    for ns in (J, T):
        srv = ns.adminz.AdminServer(port=0, host="127.0.0.1").start()
        try:
            texts.append(_get(srv.url + "/metrics")[1])
        finally:
            srv.close()
    texts = ["".join(ln for ln in t.splitlines(True)
                     if "alink_admin_port" not in ln) for t in texts]
    assert texts[0] == texts[1] == "# TYPE alink_unit_total counter\n" \
        "alink_unit_total 1.0\n"


def test_admin_tracez_bounds_equal(monkeypatch):
    jax_side, port = _both(_a_tracez, monkeypatch)
    assert port == jax_side
    assert port[0] == (200, 3, 6, ["e3", "e4", "e5"])
    assert port[1][1] == 2 and port[2][1] == 3
    assert port[3][1:] == (3, 6, ["e1", "e3", "e5"])


def test_admin_shared_instance_refcount_equal(monkeypatch):
    jax_side, port = _both(_a_shared, monkeypatch)
    assert port == jax_side
    assert port == (None, True, 200, True, None)


def test_port_admin_plane_has_no_compile_ledger():
    srv = t_adminz.AdminServer(port=0, host="127.0.0.1").start()
    try:
        assert _get(srv.url + "/compilez")[0] == 404
        st = json.loads(_get(srv.url + "/statusz")[1])
        assert "torch" in st["build"] and "jax" not in st["build"]
    finally:
        srv.close()
    assert "/compilez" not in t_adminz.AdminServer.ENDPOINTS


# -- the profile collector's host half ----------------------------------------

def _f_attribution(ns):
    col = ns.profiling2.ProfileCollector()
    with col.workload("w"):
        col._mark("w", "exec", "dispatch", 0.5)        # not measured
        with col.measured_region():
            col._mark("w", "exec", "dispatch", 0.25, n=3)
            col._mark("w", "exec", "device", 0.125)
            col._mark("w", "fetch", "transfer", 0.0625, nbytes=4096)
            with col.measured_region():                 # nested
                col._mark("w", "drain", "device", 0.0)
        col._record_window("w", "exec", None, 0.5)
    attr = col.workload_attribution("w")
    wall = attr.pop("measured_wall_s")
    host = attr.pop("host_s")
    summary = col.summary()
    summary.pop("captures", None)
    for w in summary["workloads"].values():
        w.pop("measured_wall_s")
        w.pop("host_s")
    summary.pop("enabled")
    col.discard_workload("w")
    return (attr, wall >= 0.0, host >= 0.0, summary,
            col.workload_attribution("nope"), col.summary()["marks"])


def _f_switch(ns, monkeypatch):
    monkeypatch.delenv("ALINK_TPU_PROFILE", raising=False)
    off = (ns.profiling2.profile_window("s").on,
           ns.profiling2.hbm_snapshot("s"))
    ns.profiling2.mark("s", "device", 1.0)             # a no-op when off
    monkeypatch.setenv("ALINK_TPU_PROFILE", "1")
    col = ns.profiling2.ProfileCollector()
    prev = ns.profiling2.set_profiler(col)
    try:
        with ns.profiling2.workload("w2"):
            with ns.profiling2.measured_region():
                with ns.profiling2.profile_window("exec") as win:
                    win.dispatch(0.5)
                    win.device(0.25)
                    win.transfer(0.125, nbytes=64)
                ns.profiling2.mark("exec", "collective", 0.0)
        try:
            ns.profiling2.mark("exec", "bogus", 1.0)
            bad = None
        except ValueError:
            bad = "ValueError"
        attr = col.workload_attribution("w2")
    finally:
        ns.profiling2.set_profiler(prev)
        monkeypatch.delenv("ALINK_TPU_PROFILE")
    return (off, bad, {k: attr[k] for k in ("dispatch_s", "device_s",
                                            "transfer_s", "collective_s",
                                            "dispatch_calls",
                                            "transfer_bytes",
                                            "device_scopes", "source")},
            [w["count"] for w in col.summary()["windows"]])


def test_profile_attribution_equal():
    jax_side, port = _both(_f_attribution)
    assert port == jax_side
    attr = port[0]
    assert attr["dispatch_s"] == 0.25 and attr["dispatch_calls"] == 3
    assert attr["device_s"] == 0.125 and attr["transfer_bytes"] == 4096
    assert attr["device_scopes"] == ["exec"]
    assert attr["source"] == "timing-harness"
    assert port[4] is None and port[5] == []


def test_profile_switch_and_windows_equal(monkeypatch):
    jax_side, port = _both(_f_switch, monkeypatch)
    assert port == jax_side
    assert port[0] == (False, None) and port[1] == "ValueError"
    assert port[2]["transfer_bytes"] == 64 and port[3] == [1]


def test_profile_export_and_live_bytes(tmp_path, monkeypatch):
    """The port's export is the JAX package's artifact without its
    capture and donation sections; live device bytes are 0 without
    CUDA (the JAX package's are its live arrays')."""
    col = t_profiling2.ProfileCollector()
    with col.workload("w"), col.measured_region():
        col._mark("w", "s", "device", 0.5)
    path = col.export(str(tmp_path / "p.json"))
    with open(path) as f:
        doc = json.load(f)
    assert doc["format"] == "alink_tpu_profile_v1"
    assert sorted(doc) == ["enabled", "format", "hbm", "marks", "windows",
                           "workloads"]
    assert doc["workloads"]["w"]["device_s"] == 0.5
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert t_profiling2.live_hbm_bytes() == 0
    monkeypatch.setenv("ALINK_TPU_PROFILE", "1")
    assert col.hbm_snapshot("s") == 0
    assert col.summary()["hbm"][0]["count"] == 1


# -- the engine's, FTRL's, the checkpoint store's and the operators' series ---

# Series the port does not emit: the compile plane's (the program cache,
# its compiles and storms, the programs' static cost gauges) and the
# engine's step timer, whose ``program`` label is that cache's status.
# They wait for a program cache (ROADMAP A10(b)); eager PyTorch caches
# no program.
_COMPILE_PLANE = ("alink_compile_", "alink_comqueue_program_cache_total",
                  "alink_program_", "alink_step_timer_seconds")
# byte counters of payloads whose layout differs by design: the JAX
# package's engine snapshot holds its stacked, padded while-loop carry
_LAYOUT_BYTES = {("alink_checkpoint_bytes_total", '{"scope": "comqueue"}')}
# the series that the JAX package's FTRL steps move with their margin
# AllReduce across feature shards; the port's one-device step makes none
_MARGIN_REDUCE = ("alink_collective_calls_total",
                  "alink_collective_logical_bytes_total")


def _series_counts(snapshot):
    """``{(name, labels): (kind, count)}``: counters' values, histograms'
    observation counts, and gauges by name and labels only (their values
    are times, depths and tags)."""
    out = {}
    for e in snapshot:
        if e["name"].startswith(_COMPILE_PLANE):
            continue
        key = (e["name"], json.dumps(e["labels"], sort_keys=True))
        if e["kind"] == "histogram":
            val = e["count"]
        elif e["kind"] == "counter" and key not in _LAYOUT_BYTES:
            val = e["value"]
        else:
            val = None
        out[key] = (e["kind"], val)
    return out


def _training_runs(pkg, tmp):
    """One L-BFGS run with checkpoints, one KMeans run, one batch-mode
    FTRL drain with checkpoints behind a batch LR warm start; returns the
    registry's snapshot from just before the drain."""
    import jax
    import numpy as np
    import torch
    rng = np.random.RandomState(0)
    n, d = 320, 6
    X = rng.randn(n, d)
    y = (X @ rng.randn(d) > 0).astype(np.int64)
    data = {"X": X, "y": np.where(y > 0, 1.0, -1.0), "w": np.ones(n)}
    if pkg == "jax":
        from alink_tpu.common.mlenv import MLEnvironment, MLEnvironmentFactory
        from alink_tpu.common.mtable import MTable
        from alink_tpu.common.vector import DenseVector
        from alink_tpu.operator.batch.classification.linear import \
            LogisticRegressionTrainBatchOp as LR
        from alink_tpu.operator.batch.source.sources import \
            MemSourceBatchOp as Mem
        from alink_tpu.operator.common.clustering import kmeans as km
        from alink_tpu.operator.common.optim import objfunc as obj
        from alink_tpu.operator.common.optim import optimizers as opt
        from alink_tpu.operator.stream.onlinelearning.ftrl import \
            FtrlTrainStreamOp as Ftrl
        from alink_tpu.operator.stream.source.sources import \
            MemSourceStreamOp as Src
        env = MLEnvironment(parallelism=1, devices=jax.devices()[:1])
        prev = MLEnvironmentFactory.get_default()
        MLEnvironmentFactory.set_default(env)
        dev = {}
    else:
        from alink_tpu_torch.common.mlenv import MLEnvironment
        from alink_tpu_torch.common.mtable import MTable
        from alink_tpu_torch.common.vector import DenseVector
        from alink_tpu_torch.operator.batch.classification.linear import \
            LogisticRegressionTrainBatchOp as LR
        from alink_tpu_torch.operator.batch.source.sources import \
            MemSourceBatchOp as Mem
        from alink_tpu_torch.operator.common.clustering import kmeans as km
        from alink_tpu_torch.operator.common.optim import objfunc as obj
        from alink_tpu_torch.operator.common.optim import optimizers as opt
        from alink_tpu_torch.operator.stream.onlinelearning.ftrl import \
            FtrlTrainStreamOp as Ftrl
        from alink_tpu_torch.operator.stream.source.sources import \
            MemSourceStreamOp as Src
        env = MLEnvironment(device="cpu")
        dev = {"device": "cpu"}
    try:
        o = obj.UnaryLossObjFunc(obj.LogLossFunc(), d, l2=1e-3)
        opt.optimize(o, data, opt.OptimParams(
            max_iter=6, epsilon=0.0, checkpoint_dir=os.path.join(tmp, "qn"),
            checkpoint_every=2), env)
        km.kmeans_train(X, 3, init="RANDOM", max_iter=5, tol=0.0, env=env)
        vecs = np.empty(n, object)
        vecs[:] = [DenseVector(x) for x in X]
        tbl = MTable({"vec": vecs, "label": y}, "vec VECTOR, label LONG")
        lr_kw = dict(dev, dtype=torch.float64) if dev else {}
        warm = LR(vector_col="vec", label_col="label", max_iter=3,
                  **lr_kw).link_from(Mem(tbl.first_n(100)))
        ftrl_kw = dict(dev, ship_dtype=torch.float64) if dev else {}
        op = Ftrl(warm, vector_col="vec", label_col="label",
                  update_mode="batch", time_interval=2.0,
                  checkpoint_dir=os.path.join(tmp, "ftrl"),
                  checkpoint_every_batches=3, **ftrl_kw).link_from(
            Src(tbl, batch_size=40))
        before = (J if pkg == "jax" else T).metrics.get_registry().snapshot()
        for _ in op.timed_batches():
            pass
        return before
    finally:
        if pkg == "jax":
            MLEnvironmentFactory.set_default(prev)


def test_training_series_equal_the_jax_package(tmp_path, monkeypatch):
    """L-BFGS with checkpoints, KMeans, a batch LR op and a checkpointed
    FTRL drain give the JAX package's series: the same names and labels,
    counters' values and histograms' counts (not the seconds), apart
    from the compile plane's series, which the port does not have, and
    the FTRL steps' margin AllReduce, which the port's one-device step
    does not make: the drain moves no ``alink_collective_*`` series in
    the port, and in the JAX package those series are held at their
    values from before the drain; the trace holds the engine's, the
    snapshot writer's and the FTRL drain's spans and instants."""
    monkeypatch.setenv("ALINK_TPU_TRACE", "1")
    got, before = {}, {}
    for pkg, ns in (("jax", J), ("torch", T)):
        pre = _training_runs(pkg, str(tmp_path / pkg))
        got[pkg] = _series_counts(ns.metrics.get_registry().snapshot())
        before[pkg] = {k: v for k, v in _series_counts(pre).items()
                       if k[0].startswith(_MARGIN_REDUCE)}
    assert before["jax"] and before["torch"] == before["jax"]
    drained = {k: v for k, v in got["jax"].items()
               if k[0].startswith(_MARGIN_REDUCE) and v != before["jax"][k]}
    assert drained       # the JAX package's drain counts its AllReduce
    assert {k: got["torch"][k] for k in before["torch"]} == before["torch"]
    got["jax"].update(before["jax"])
    assert got["torch"] == got["jax"]
    names = {k[0] for k in got["torch"]}
    for want in ("alink_comqueue_execs_total",
                 "alink_comqueue_supersteps_total",
                 "alink_collective_calls_total",
                 "alink_checkpoint_total", "alink_checkpoint_last_tag",
                 "alink_overlap_snapshot_writes_total",
                 "alink_overlap_submit_wait_seconds",
                 "alink_batch_op_seconds", "alink_batch_rows_in_total",
                 "alink_ftrl_batch_seconds", "alink_ftrl_rows_total",
                 "alink_ftrl_snapshots_total", "alink_stream_batches_total"):
        assert want in names, want
    events = {e["name"] for e in T.tracing.get_tracer().events()}
    assert {"comqueue.exec", "snapshot.write", "snapshot.submit",
            "checkpoint.save", "link:LogisticRegressionTrainBatchOp",
            "ftrl.batch", "ftrl.snapshot"} <= events
