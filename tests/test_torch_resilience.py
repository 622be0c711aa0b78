"""The serving tier's resilience in the port against the JAX package.

``alink_tpu_torch/serving/resilience.py`` is a copy of the JAX
package's, ``serving/server.py`` ports its deadlines, shedding, breaker
routing, supervised loop and feeders, and ``common/faults.py`` carries
the ``serve.dispatch``, ``serve.swap`` and ``feeder.snapshot`` sites.
Every case runs the same script through both packages and holds the
port's trajectory, counts and answers equal to the JAX package's:

* ``CircuitBreaker`` under a fake clock: the route of every dispatch,
  the state after every verdict, the transitions;
* the fault grammar: which visits raise, sleep or signal corruption,
  and which specs are refused;
* a ``PredictServer`` on the CPU (the port's in float64, the JAX
  package's under x64 on one device, one model table carried across):
  deadline shedding, cancellation, the breaker's open / degrade /
  recover cycle, loop respawn and quarantine, answers bitwise;
* the feeders' retries and skips under scripted swap and snapshot
  errors, FTRL's ``feeder.snapshot`` corruption included.
"""

import time
import warnings
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import alink_tpu.common.faults as j_faults
import alink_tpu.common.metrics as j_metrics
import alink_tpu.serving as j_serving
import alink_tpu.serving.resilience as j_res
import alink_tpu_torch.common.faults as t_faults
import alink_tpu_torch.common.metrics as t_metrics
import alink_tpu_torch.serving as t_serving
import alink_tpu_torch.serving.resilience as t_res

FAULT_ENV = "ALINK_TPU_FAULT_INJECT"

J = SimpleNamespace(faults=j_faults, metrics=j_metrics, serving=j_serving,
                    res=j_res, name="jax")
T = SimpleNamespace(faults=t_faults, metrics=t_metrics, serving=t_serving,
                    res=t_res, name="torch")


def _both(scenario, *args):
    return scenario(J, *args), scenario(T, *args)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """Faults disarmed and counted from zero, fresh registries, the
    breaker and feeder flags at their defaults, in both packages."""
    for k in (FAULT_ENV, "ALINK_TPU_SERVE_BREAKER",
              "ALINK_TPU_SERVE_BREAKER_THRESHOLD",
              "ALINK_TPU_SERVE_BREAKER_BACKOFF_MS",
              "ALINK_TPU_SERVE_BREAKER_FACTOR",
              "ALINK_TPU_SERVE_BREAKER_MAX_MS",
              "ALINK_TPU_SERVE_FEEDER_RETRIES",
              "ALINK_TPU_SERVE_FEEDER_BACKOFF_MS"):
        monkeypatch.delenv(k, raising=False)
    saved = []
    for ns in (J, T):
        ns.faults.reset_faults()
        ns.res._reset_feeder_warnings()
        saved.append((ns, ns.metrics.set_registry(
            ns.metrics.MetricsRegistry())))
    yield monkeypatch
    monkeypatch.delenv(FAULT_ENV, raising=False)
    for ns, reg in saved:
        ns.faults.reset_faults()
        ns.metrics.set_registry(reg)


def _metric(ns, name, **labels):
    total = 0.0
    for rec in ns.metrics.get_registry().snapshot():
        lb = rec.get("labels") or {}
        if rec["name"] == name and all(lb.get(k) == v
                                       for k, v in labels.items()):
            total += rec.get("value") or 0.0
    return total


# -- the breaker's state machine ----------------------------------------------

class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


# scripts: ("acq",) | ("ok", probe) | ("fail", probe) | ("t", +seconds)
# | ("retire",)
BREAKER_SCRIPTS = {
    "full_cycle": ((3, 0.1, 2.0, 1.0), [
        ("acq",), ("fail", False), ("acq",), ("fail", False), ("acq",),
        ("fail", False), ("acq",), ("t", 0.11), ("acq",), ("acq",),
        ("ok", True), ("acq",)]),
    "no_flap": ((1, 0.1, 2.0, 1.0), [
        ("acq",), ("fail", False), ("t", 0.11), ("acq",), ("fail", True),
        ("t", 0.11), ("acq",), ("t", 0.11), ("acq",), ("fail", True),
        ("t", 0.41), ("acq",), ("ok", True), ("fail", False), ("acq",)]),
    "success_resets": ((2, 0.1, 2.0, 1.0), [
        ("fail", False), ("ok", False), ("fail", False), ("acq",),
        ("fail", False), ("acq",)]),
    "stale_verdicts": ((1, 0.1, 2.0, 1.0), [
        ("acq",), ("fail", False), ("t", 0.11), ("acq",), ("ok", False),
        ("acq",), ("fail", False), ("ok", True), ("acq",)]),
    "capped_backoff": ((1, 0.05, 3.0, 0.2), [
        ("fail", False), ("t", 0.06), ("acq",), ("fail", True),
        ("t", 0.16), ("acq",), ("fail", True), ("t", 0.19), ("acq",),
        ("t", 0.02), ("acq",), ("fail", True), ("t", 0.21), ("acq",)]),
    "retired": ((1, 0.1, 2.0, 1.0), [
        ("acq",), ("fail", False), ("retire",), ("t", 0.2), ("acq",),
        ("ok", True), ("fail", True), ("acq",)]),
}


def _trajectory(ns, args, script):
    clk = _Clock()
    threshold, backoff, factor, max_s = args
    br = ns.res.CircuitBreaker("t", 1, threshold=threshold,
                               backoff_s=backoff, factor=factor,
                               max_s=max_s, clock=clk)
    out = []
    for op in script:
        if op[0] == "acq":
            out.append(("acq", br.acquire()))
        elif op[0] == "ok":
            br.on_success(probe=op[1])
        elif op[0] == "fail":
            br.on_failure(probe=op[1])
        elif op[0] == "retire":
            br.retire()
        else:
            clk.t += op[1]
        out.append(br.snapshot())
    return out, list(br.transitions), [br.backoff_for(k) for k in range(5)]


@pytest.mark.parametrize("name", sorted(BREAKER_SCRIPTS))
def test_breaker_trajectory_equals_the_jax_package(name):
    args, script = BREAKER_SCRIPTS[name]
    jax_side, port = _both(_trajectory, args, script)
    assert port == jax_side
    states = {s["state"] for s in port[0] if isinstance(s, dict)}
    assert "open" in states          # every script trips the breaker


def test_breaker_full_cycle_pinned():
    traj, transitions, _ = _trajectory(T, *BREAKER_SCRIPTS["full_cycle"])
    routes = [t[1] for t in traj if isinstance(t, tuple)]
    assert routes == ["compiled", "compiled", "compiled", "fallback",
                      "probe", "fallback", "compiled"]
    assert [(f, t) for f, t, _ in transitions] == [
        ("closed", "open"), ("open", "half-open"), ("half-open", "closed")]


def _defaults(ns, monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    br = ns.res.CircuitBreaker("d", 1)
    got = (br.threshold, br.base_s, br.factor, br.max_s,
           ns.res.serve_breaker_enabled(), ns.res.feeder_retries(),
           ns.res.feeder_backoff_s())
    for k in env:
        monkeypatch.delenv(k)
    return got


@pytest.mark.parametrize("env", [
    {},
    {"ALINK_TPU_SERVE_BREAKER_THRESHOLD": "0",
     "ALINK_TPU_SERVE_BREAKER_BACKOFF_MS": "-5",
     "ALINK_TPU_SERVE_BREAKER_FACTOR": "0.5",
     "ALINK_TPU_SERVE_BREAKER_MAX_MS": "200",
     "ALINK_TPU_SERVE_BREAKER": "off",
     "ALINK_TPU_SERVE_FEEDER_RETRIES": "-1",
     "ALINK_TPU_SERVE_FEEDER_BACKOFF_MS": "7"},
    {"ALINK_TPU_SERVE_BREAKER_THRESHOLD": "5",
     "ALINK_TPU_SERVE_BREAKER_BACKOFF_MS": "",
     "ALINK_TPU_SERVE_BREAKER": "1"}])
def test_breaker_and_feeder_flags_resolve_like_the_jax_package(
        monkeypatch, env):
    jax_side, port = _both(_defaults, monkeypatch, env)
    assert port == jax_side


# -- the fault grammar ----------------------------------------------------------

FAULT_SCRIPTS = {
    "kill_open_ended": ("a.b:3; c.d:1", [("a.b", 2), ("other", 99),
                                          ("a.b", 5), ("c.d", 1)]),
    "range_clears": ("s.x:2-3:error", [("s.x", i) for i in range(1, 5)]),
    "delay": ("s.d:1:delay:20", [("s.d", 1), ("s.d", 2)]),
    "corrupt_window": ("s.c:2-2:corrupt", [("s.c", i) for i in (1, 2, 3)]),
    "auto_index": ("s.auto:2-2:corrupt;serve.dispatch:1-2:error",
                   [("s.auto", None)] * 3 + [("serve.dispatch", None)] * 3),
    "serving_sites": ("serve.swap:1:kill;feeder.snapshot:2-3:corrupt",
                      [("feeder.snapshot", None)] * 4
                      + [("serve.swap", None)]),
}


def _visits(ns, spec, visits, monkeypatch):
    monkeypatch.setenv(FAULT_ENV, spec)
    ns.faults.reset_faults()
    out = []
    for site, idx in visits:
        t0 = time.perf_counter()
        try:
            r = ns.faults.maybe_crash(site, idx)
            out.append(("ret", r, time.perf_counter() - t0 >= 0.015))
        except ns.faults.FaultInjected as e:
            out.append(("kill", e.site, e.threshold))
        except ns.faults.TransientFault as e:
            out.append(("error", type(e).__mro__[1].__name__,
                        isinstance(e, RuntimeError)))
    monkeypatch.delenv(FAULT_ENV)
    return out


@pytest.mark.parametrize("name", sorted(FAULT_SCRIPTS))
def test_fault_visits_equal_the_jax_package(monkeypatch, name):
    spec, visits = FAULT_SCRIPTS[name]
    jax_side, port = _both(_visits, spec, visits, monkeypatch)
    assert port == jax_side
    # something fired: a raise, a corruption signal or a sleep
    assert any(v[0] != "ret" or v[1] or v[2] for v in port)


@pytest.mark.parametrize("spec", [
    "justasite", "s.x:1:frobnicate", "s.x:1:delay", "s.x:1:delay:NaNms",
    "s.x:5-2:error", "s.x:1:error:9", "serve.dispatch:oops",
    "serve.dispatch:1-14:error;serve.dispatch:20:delay:30"])
def test_malformed_fault_specs_refused_like_the_jax_package(
        monkeypatch, spec):
    monkeypatch.setenv(FAULT_ENV, spec)
    msgs = []
    for ns in (J, T):
        with pytest.raises(ValueError) as ei:
            ns.faults.fault_spec()
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1] and FAULT_ENV in msgs[1]


def test_scoped_fault_env_resets_counters(monkeypatch):
    def run(ns):
        out = []
        for _ in range(2):
            with ns.faults.scoped_fault_env("s.scope:2-2:corrupt"):
                out += [ns.faults.maybe_crash("s.scope") for _ in range(3)]
        return out
    jax_side, port = _both(run)
    assert port == jax_side == [False, True, False] * 2


# -- the server: one model in both packages -------------------------------------

def _tables(seed=0, n=192, d=12):
    from alink_tpu.common.mtable import MTable
    from alink_tpu.common.vector import DenseVector
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d)
    y = (X @ rng.randn(d) > 0).astype(np.int64)
    vecs = np.empty(n, object)
    vecs[:] = [DenseVector(X[i]) for i in range(n)]
    return X, y, MTable({"vec": vecs, "label": y}, "vec VECTOR, label LONG")


@pytest.fixture(scope="module")
def case():
    """One JAX-trained LR model (on a 1-device environment), carried to
    the port; each package gets its mapper, request rows and a
    predictor factory (the port's on the CPU in float64)."""
    from alink_tpu.common.mlenv import MLEnvironment, MLEnvironmentFactory
    from alink_tpu.common.params import Params as JParams
    from alink_tpu.operator.batch.classification.linear import (
        LogisticRegressionTrainBatchOp)
    from alink_tpu.operator.batch.source.sources import MemSourceBatchOp
    from alink_tpu.operator.common.linear.mapper import \
        LinearModelMapper as JMapper
    from alink_tpu_torch.common.mtable import MTable as TMTable
    from alink_tpu_torch.common.params import Params as TParams
    from alink_tpu_torch.common.vector import DenseVector as TDense
    from alink_tpu_torch.model.interop import model_table_from_reference
    from alink_tpu_torch.operator.common.linear.mapper import \
        LinearModelMapper as TMapper
    sid = MLEnvironmentFactory.register(
        MLEnvironment(parallelism=1, devices=jax.devices()[:1]))
    pp = {"prediction_col": "pred", "vector_col": "vec"}

    def models(seed):
        X, y, tbl = _tables(seed)
        warm = LogisticRegressionTrainBatchOp(
            vector_col="vec", label_col="label", max_iter=3,
            ml_environment_id=sid).link_from(
            MemSourceBatchOp(tbl, ml_environment_id=sid))
        jt = warm.get_output_table()
        tt = model_table_from_reference(jt.to_rows(), jt.schema.types[2])
        return X, y, tbl, jt, tt

    X, y, tbl, jt, tt = models(0)
    _, _, _, jt9, tt9 = models(9)
    jreq = tbl.select(["vec"])
    treq = TMTable([(TDense(x),) for x in X], "vec VECTOR")
    jm = JMapper(jt.schema, jreq.schema, JParams(pp))
    jm.load_model(jt)
    tm = TMapper(tt.schema, treq.schema, TParams(pp))
    tm.load_model(tt)
    J.req, J.mapper, J.table, J.table9 = jreq, jm, jt, jt9
    T.req, T.mapper, T.table, T.table9 = treq, tm, tt, tt9
    J.pred = lambda buckets, name: j_serving.CompiledPredictor(
        jm, buckets=buckets, name=name)
    T.pred = lambda buckets, name: t_serving.CompiledPredictor(
        tm, buckets=buckets, name=name, device="cpu",
        ship_dtype=torch.float64)
    yield X, y
    MLEnvironmentFactory.remove(sid)


def _server(ns, name, buckets=(1, 4), max_batch=1):
    pred = ns.pred(buckets, name)
    for b in buckets:
        pred.predict_table(ns.req.first_n(b))
    return ns.serving.PredictServer(pred, max_batch=max_batch, name=name)


def _outcome(fut, timeout=30):
    try:
        return ("ok", tuple(str(v) for v in fut.result(timeout)))
    except Exception as e:     # the typed rejection's class, by name
        return ("err", type(e).__name__)


def _stats(srv):
    st = srv.stats()
    return {k: st[k] for k in ("requests", "failed", "batches", "shed",
                               "fallback_batches", "loop_respawns",
                               "quarantined", "model_version")} | {
        "breaker": {k: st["breaker"][k]
                    for k in ("state", "opens", "reopens", "probes",
                              "step")}}


def _s_deadline(ns, monkeypatch):
    srv = _server(ns, "shed")
    row = ns.req.row(0)
    try:
        ns.faults.reset_faults()
        monkeypatch.setenv(FAULT_ENV, "serve.dispatch:1-1:delay:300")
        before = _metric(ns, "alink_serve_batches_total")
        f1 = srv.submit(row)
        time.sleep(0.05)                  # f1 is in its delayed dispatch
        f2 = srv.submit(row, deadline_s=0.001)
        got = [_outcome(f1), _outcome(f2)]
        err = None
        try:
            f2.result(1)
        except Exception as e:
            err = (e.deadline_s, e.waited_s > e.deadline_s)
        return (got, err, _metric(ns, "alink_serve_batches_total") - before,
                _metric(ns, "alink_serve_shed_total", reason="deadline"),
                _stats(srv))
    finally:
        monkeypatch.delenv(FAULT_ENV)
        srv.close()


def _s_cancel_and_timeout(ns, monkeypatch):
    srv = _server(ns, "cxl")
    row = ns.req.row(1)
    try:
        ns.faults.reset_faults()
        monkeypatch.setenv(FAULT_ENV, "serve.dispatch:1-1:delay:200")
        f1 = srv.submit(row)
        time.sleep(0.05)
        f2 = srv.submit(row)
        marked = f2.cancel()
        try:
            f1.result(0.005)
            early = None
        except TimeoutError as e:
            early = "deadline_s" in str(e)
        got = [_outcome(f1), _outcome(f2), marked, f2.cancel(), early,
               _metric(ns, "alink_serve_shed_total", reason="cancelled")]
        return got, _stats(srv)
    finally:
        monkeypatch.delenv(FAULT_ENV)
        srv.close()


def _s_storm(ns, monkeypatch, spec):
    monkeypatch.setenv("ALINK_TPU_SERVE_BREAKER_THRESHOLD", "2")
    monkeypatch.setenv("ALINK_TPU_SERVE_BREAKER_BACKOFF_MS", "40")
    srv = _server(ns, "storm")
    row = ns.req.row(2)
    try:
        ns.faults.reset_faults()
        monkeypatch.setenv(FAULT_ENV, spec)
        out = [_outcome(srv.submit(row)) for _ in range(2)]
        out.append(srv.breaker_stats()["state"])
        out.append(_outcome(srv.submit(row)))          # open: fallback
        time.sleep(0.06)
        compiled = _metric(ns, "alink_serve_batches_total")
        out.append(_outcome(srv.submit(row)))          # the probe
        out.append(_metric(ns, "alink_serve_batches_total") - compiled)
        out.append(_metric(ns, "alink_serve_breaker_fallback_total"))
        return out, _stats(srv)
    finally:
        monkeypatch.delenv(FAULT_ENV)
        srv.close()


def _s_breaker_off(ns, monkeypatch):
    monkeypatch.setenv("ALINK_TPU_SERVE_BREAKER", "0")
    srv = _server(ns, "nobrk")
    try:
        ns.faults.reset_faults()
        monkeypatch.setenv(FAULT_ENV, "serve.dispatch:1-4:error")
        out = [_outcome(srv.submit(ns.req.row(3))) for _ in range(5)]
        return out, _stats(srv)
    finally:
        monkeypatch.delenv(FAULT_ENV)
        monkeypatch.delenv("ALINK_TPU_SERVE_BREAKER")
        srv.close()


def _s_swap_resets(ns, monkeypatch):
    monkeypatch.setenv("ALINK_TPU_SERVE_BREAKER_THRESHOLD", "2")
    srv = _server(ns, "perver")
    row = ns.req.row(4)
    try:
        ns.faults.reset_faults()
        monkeypatch.setenv(FAULT_ENV, "serve.dispatch:1-2:error")
        out = [_outcome(srv.submit(row)) for _ in range(2)]
        out.append(srv.breaker_stats()["state"])
        monkeypatch.delenv(FAULT_ENV)
        out.append(srv.swap_model(ns.table9))
        out.append(_outcome(srv.submit(row)))
        return out, _stats(srv)
    finally:
        srv.close()


def _s_kill_respawn(ns, monkeypatch):
    srv = _server(ns, "crash", buckets=(1,))
    row = ns.req.row(5)
    try:
        ns.faults.reset_faults()
        monkeypatch.setenv(FAULT_ENV, "serve.dispatch:1-1:kill")
        fut = srv.submit(row)
        first = _outcome(fut)
        try:
            fut.result(1)
        except Exception as e:
            cause = type(e.cause).__name__
        second = _outcome(srv.submit(row))
        return (first, cause, second, _stats(srv),
                _metric(ns, "alink_serve_loop_respawns_total",
                        server="crash"))
    finally:
        monkeypatch.delenv(FAULT_ENV)
        srv.close()


def _s_channel_fault(ns, monkeypatch):
    pred = ns.pred((1,), "chfault")
    pred.predict_table(ns.req.first_n(1))
    ns.faults.reset_faults()
    monkeypatch.setenv(FAULT_ENV, "prefetch.get:1-1:error")
    srv = ns.serving.PredictServer(pred, max_batch=1, name="chfault")
    try:
        got = _outcome(srv.submit(ns.req.row(6)))
        return got, srv.stats()["loop_respawns"] >= 1
    finally:
        monkeypatch.delenv(FAULT_ENV)
        srv.close()


def _s_probe_escape(ns, monkeypatch):
    monkeypatch.setenv("ALINK_TPU_SERVE_BREAKER_THRESHOLD", "1")
    monkeypatch.setenv("ALINK_TPU_SERVE_BREAKER_BACKOFF_MS", "30")
    srv = _server(ns, "probeleak", buckets=(1,))
    row = ns.req.row(7)
    try:
        ns.faults.reset_faults()
        monkeypatch.setenv(FAULT_ENV, "serve.dispatch:1-2:kill")
        out = [_outcome(srv.submit(row)), srv.breaker_stats()["state"]]
        time.sleep(0.05)
        out += [_outcome(srv.submit(row)), srv.breaker_stats()["state"],
                srv.breaker_stats()["reopens"]]
        time.sleep(0.12)
        out += [_outcome(srv.submit(row)), srv.breaker_stats()["state"]]
        return out, _stats(srv)
    finally:
        monkeypatch.delenv(FAULT_ENV)
        srv.close()


SERVER_SCENARIOS = {
    "deadline_shed": _s_deadline,
    "cancel_and_timeout": _s_cancel_and_timeout,
    "storm_recovers": lambda ns, mp: _s_storm(ns, mp,
                                              "serve.dispatch:1-2:error"),
    "failed_probe_reopens": lambda ns, mp: _s_storm(
        ns, mp, "serve.dispatch:1-3:error"),
    "breaker_off": _s_breaker_off,
    "swap_resets_breaker": _s_swap_resets,
    "kill_respawns": _s_kill_respawn,
    "channel_fault_respawns": _s_channel_fault,
    "probe_escape_released": _s_probe_escape,
}


@pytest.mark.parametrize("name", sorted(SERVER_SCENARIOS))
def test_server_resilience_equals_the_jax_package(case, monkeypatch, name):
    jax_side, port = _both(SERVER_SCENARIOS[name], monkeypatch)
    assert port == jax_side
    flat = repr(port)
    assert "ok" in flat                  # the server answered in every one


def test_deadline_shed_never_reaches_the_device(case, monkeypatch):
    got, err, dispatched, shed, st = _s_deadline(T, monkeypatch)
    assert got[0][0] == "ok" and got[1] == ("err", "DeadlineExceeded")
    assert err[0] == pytest.approx(0.001) and err[1]
    assert dispatched == 1 and shed == 1
    assert st["shed"] == 1 and st["failed"] == 0


def test_storm_degrades_to_correct_answers_and_recovers(case, monkeypatch):
    out, st = _s_storm(T, monkeypatch, "serve.dispatch:1-2:error")
    expected = ("ok", tuple(str(v) for v in T.mapper.map_row(T.req.row(2))))
    assert out[:3] == [("err", "TransientFault")] * 2 + ["open"]
    assert out[3] == expected and out[4] == expected
    assert out[5] == 1 and out[6] >= 1          # the probe ran on the device
    assert st["breaker"]["state"] == "closed" and st["failed"] == 2
    assert st["fallback_batches"] == 1


def test_kill_quarantines_and_respawns(case, monkeypatch):
    first, cause, second, st, respawns = _s_kill_respawn(T, monkeypatch)
    assert first == ("err", "ReplicaCrashed") and cause == "FaultInjected"
    assert second[0] == "ok"
    assert st["loop_respawns"] == 1 and st["quarantined"] == 1
    assert respawns == 1


# -- the feeders' supervision -------------------------------------------------

class _ListStream:
    """A minimal stream op: timed_batches() yields the given tables."""

    def __init__(self, tables):
        self._tables = list(tables)

    def timed_batches(self):
        for i, t in enumerate(self._tables):
            yield (float(i), t)


def _corrupt(ns, table):
    if ns is J:
        from alink_tpu.operator.stream.onlinelearning.ftrl import \
            _corrupt_snapshot_table
    else:
        from alink_tpu_torch.operator.stream.onlinelearning.ftrl import \
            _corrupt_snapshot_table
    return _corrupt_snapshot_table(table)


def _f_poisoned(ns, monkeypatch):
    srv = _server(ns, "poison")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            feeder = ns.serving.ModelStreamFeeder(srv, _ListStream(
                [ns.table, _corrupt(ns, ns.table), ns.table9])).start()
            swaps = feeder.join(timeout=60)
        return (swaps, feeder.skipped, feeder.retried,
                [v for v, _ in feeder.versions],
                srv.stats()["model_version"],
                _metric(ns, "alink_serve_feeder_errors_total",
                        feeder="ModelStreamFeeder", kind="poisoned"),
                sum("poisoned" in str(w.message) for w in caught),
                _outcome(srv.submit(ns.req.row(8))))
    finally:
        srv.close()


def _f_retry(ns, monkeypatch):
    srv = _server(ns, "retry")
    monkeypatch.setenv("ALINK_TPU_SERVE_FEEDER_BACKOFF_MS", "5")
    try:
        ns.faults.reset_faults()
        monkeypatch.setenv(FAULT_ENV, "serve.swap:1-2:error")
        feeder = ns.serving.ModelStreamFeeder(
            srv, _ListStream([ns.table9])).start()
        swaps = feeder.join(timeout=60)
        return (swaps, feeder.retried, feeder.skipped,
                _metric(ns, "alink_serve_feeder_retries_total",
                        feeder="ModelStreamFeeder"),
                _metric(ns, "alink_serve_feeder_errors_total",
                        feeder="ModelStreamFeeder", kind="transient"),
                srv.stats()["model_version"])
    finally:
        monkeypatch.delenv(FAULT_ENV)
        srv.close()


def _f_fatal(ns, monkeypatch):
    srv = _server(ns, "fatal")
    monkeypatch.setenv("ALINK_TPU_SERVE_FEEDER_BACKOFF_MS", "2")
    monkeypatch.setenv("ALINK_TPU_SERVE_FEEDER_RETRIES", "1")
    try:
        ns.faults.reset_faults()
        monkeypatch.setenv(FAULT_ENV, "serve.swap:1-50:error")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            feeder = ns.serving.ModelStreamFeeder(
                srv, _ListStream([ns.table9])).start()
            try:
                feeder.join(timeout=60)
                raised = None
            except Exception as e:
                raised = type(e).__name__
        return (raised, feeder.retried,
                _metric(ns, "alink_serve_feeder_errors_total",
                        feeder="ModelStreamFeeder", kind="fatal"),
                any("fatal" in str(w.message) for w in caught),
                srv.stats()["model_version"])
    finally:
        monkeypatch.delenv(FAULT_ENV)
        srv.close()


def _f_ftrl_corrupt(ns, monkeypatch, X, y):
    """``feeder.snapshot:1-1:corrupt`` poisons the first emitted FTRL
    snapshot; the feeder skips it and swaps the later ones."""
    if ns is J:
        from alink_tpu.common.mtable import MTable
        from alink_tpu.common.vector import DenseVector
        from alink_tpu.operator.batch.source.sources import MemSourceBatchOp
        from alink_tpu.operator.stream.onlinelearning.ftrl import \
            FtrlTrainStreamOp
        from alink_tpu.operator.stream.source.sources import \
            MemSourceStreamOp
        kw = {}
    else:
        from alink_tpu_torch.common.mtable import MTable
        from alink_tpu_torch.common.vector import DenseVector
        from alink_tpu_torch.operator.batch.source.sources import \
            MemSourceBatchOp
        from alink_tpu_torch.operator.stream.onlinelearning.ftrl import \
            FtrlTrainStreamOp
        from alink_tpu_torch.operator.stream.source.sources import \
            MemSourceStreamOp
        kw = {"device": "cpu", "ship_dtype": torch.float64}
    vecs = np.empty(len(X), object)
    vecs[:] = [DenseVector(x) for x in X]
    tbl = MTable({"vec": vecs, "label": y}, "vec VECTOR, label LONG")
    srv = _server(ns, "ftrlpois")
    try:
        ns.faults.reset_faults()
        monkeypatch.setenv(FAULT_ENV, "feeder.snapshot:1-1:corrupt")
        ftrl = FtrlTrainStreamOp(MemSourceBatchOp(ns.table), vector_col="vec",
                                 label_col="label", alpha=0.1,
                                 update_mode="batch", time_interval=1.0,
                                 **kw).link_from(
            MemSourceStreamOp(tbl, batch_size=48))
        feeder = ns.serving.ModelStreamFeeder(srv, ftrl).start()
        swaps = feeder.join(timeout=120)
        return (swaps, feeder.skipped,
                _metric(ns, "alink_serve_feeder_errors_total",
                        feeder="ModelStreamFeeder", kind="poisoned"),
                srv.stats()["model_version"],
                _outcome(srv.submit(ns.req.row(9))))
    finally:
        monkeypatch.delenv(FAULT_ENV)
        srv.close()


FEEDER_SCENARIOS = {"poisoned_skipped": _f_poisoned,
                    "transient_retried": _f_retry,
                    "budget_exhausted_fatal": _f_fatal}


@pytest.mark.parametrize("name", sorted(FEEDER_SCENARIOS))
def test_feeder_supervision_equals_the_jax_package(case, monkeypatch, name):
    jax_side, port = _both(FEEDER_SCENARIOS[name], monkeypatch)
    assert port == jax_side


def test_feeder_supervision_counts(case, monkeypatch):
    poisoned = _f_poisoned(T, monkeypatch)
    assert poisoned[:5] == (2, 1, 0, [2, 3], 3) and poisoned[5:7] == (1, 1)
    assert _f_retry(T, monkeypatch) == (1, 2, 0, 2, 2, 2)
    assert _f_fatal(T, monkeypatch) == ("TransientFault", 1, 1, True, 1)


def test_ftrl_corrupt_snapshot_skipped_like_the_jax_package(case,
                                                           monkeypatch):
    X, y = case
    jax_side, port = _both(_f_ftrl_corrupt, monkeypatch, X, y)
    assert port[:3] == jax_side[:3]
    swaps, skipped, poisoned, version, answer = port
    assert skipped == 1 and poisoned == 1 and swaps >= 1
    assert version == swaps + 1 and answer[0] == "ok"
