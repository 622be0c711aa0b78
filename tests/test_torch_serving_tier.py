"""The serving tier of the port end to end on the CPU, against the JAX
package.

The port's ``PredictServer`` in float64 answers bitwise what the JAX
package's ``LinearModelMapper.map_table`` answers for one model table
(trained by the JAX package on one device, carried across); its bucket
accounting (``cache_stats``) counts what the JAX package's program
cache counts on one request sequence, with and without a swap; a small
hot swap through ``ModelStreamFeeder`` tears no response and swaps as
many times as the JAX package's ``FtrlTrainStreamOp`` emits snapshots
on the same stream, and each table it swaps in loads in the JAX
package's mapper and answers the same; ``DeviceWeightsFeeder`` serves
the same scores as ``ModelStreamFeeder``; a small chaos run (the
``serve_chaos`` storm of ``bench.py`` at a CPU size) drops nothing
silently and recovers to device batches; ``ModelMapStreamOp``'s
compiled route answers as its host route; and every entry point raises
without CUDA unless the caller asks for the CPU. Every wait has its own
timeout.
"""

import os
import time

import jax
import numpy as np
import pytest
import torch

from alink_tpu_torch.common.faults import reset_faults, scoped_fault_env
from alink_tpu_torch.common.metrics import (MetricsRegistry, get_registry,
                                            set_registry)
from alink_tpu_torch.common.mtable import MTable as TMTable
from alink_tpu_torch.common.params import Params as TParams
from alink_tpu_torch.common.vector import DenseVector as TDense
from alink_tpu_torch.model.interop import model_table_from_reference
from alink_tpu_torch.operator.batch.source.sources import \
    MemSourceBatchOp as TMem
from alink_tpu_torch.operator.common.linear.mapper import \
    LinearModelMapper as TMapper
from alink_tpu_torch.operator.stream.onlinelearning.ftrl import \
    FtrlTrainStreamOp as TFtrl
from alink_tpu_torch.operator.stream.source.sources import \
    MemSourceStreamOp as TMemStream
from alink_tpu_torch.serving import (CompiledPredictor, DeviceWeightsFeeder,
                                     LoadGenerator, ModelStreamFeeder,
                                     PredictServer, serial_qps)
from alink_tpu_torch.serving.predictor import GeometryRefused

PP = {"prediction_col": "pred", "vector_col": "vec"}
N, D, MICRO = 384, 12, 32
FTRL_KW = dict(vector_col="vec", label_col="label", alpha=0.1,
               update_mode="batch", time_interval=1.0)


def _bits(a):
    return np.asarray(a, np.float64).view(np.int64)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for k in ("ALINK_TPU_FAULT_INJECT", "ALINK_TPU_SERVE_COMPILED",
              "ALINK_TPU_SERVE_BUCKETS"):
        monkeypatch.delenv(k, raising=False)
    reset_faults()
    prev = set_registry(MetricsRegistry())
    yield
    reset_faults()
    set_registry(prev)


@pytest.fixture(scope="module")
def case():
    """Seeded dense rows, an LR model the JAX package trains on them on
    one device, the model carried to the port, and both packages'
    request tables and mappers."""
    from alink_tpu.common.mlenv import MLEnvironment, MLEnvironmentFactory
    from alink_tpu.common.mtable import MTable
    from alink_tpu.common.params import Params
    from alink_tpu.common.vector import DenseVector
    from alink_tpu.operator.batch.classification.linear import (
        LogisticRegressionTrainBatchOp)
    from alink_tpu.operator.batch.source.sources import MemSourceBatchOp
    from alink_tpu.operator.common.linear.mapper import LinearModelMapper
    sid = MLEnvironmentFactory.register(
        MLEnvironment(parallelism=1, devices=jax.devices()[:1]))
    rng = np.random.RandomState(7)
    X = rng.randn(N, D)
    y = (X @ rng.randn(D) > 0).astype(np.int64)
    jv = np.empty(N, object)
    jv[:] = [DenseVector(x) for x in X]
    jtbl = MTable({"vec": jv, "label": y}, "vec VECTOR, label LONG")
    warm = LogisticRegressionTrainBatchOp(
        vector_col="vec", label_col="label", max_iter=4,
        ml_environment_id=sid).link_from(
        MemSourceBatchOp(jtbl.first_n(128), ml_environment_id=sid))
    jt = warm.get_output_table()
    jreq = jtbl.select(["vec"])
    jm = LinearModelMapper(jt.schema, jreq.schema, Params(PP))
    jm.load_model(jt)
    tt = model_table_from_reference(jt.to_rows(), jt.schema.types[2])
    tv = np.empty(N, object)
    tv[:] = [TDense(x) for x in X]
    ttbl = TMTable({"vec": tv, "label": y}, "vec VECTOR, label LONG")
    treq = ttbl.select(["vec"])
    tm = TMapper(tt.schema, treq.schema, TParams(PP))
    tm.load_model(tt)
    yield dict(sid=sid, X=X, y=y, jtbl=jtbl, jt=jt, jreq=jreq, jm=jm,
               warm=warm, tt=tt, ttbl=ttbl, treq=treq, tm=tm)
    MLEnvironmentFactory.remove(sid)


def _predictor(case, name="serve", buckets=None):
    return CompiledPredictor(case["tm"], buckets=buckets, device="cpu",
                             ship_dtype=torch.float64, name=name)


def _jax_table(table):
    """The port's model table as the JAX package's, through plain rows."""
    from alink_tpu.common.mtable import MTable
    return MTable(table.to_rows(), table.schema.to_spec())


def _jax_mapper(case, table):
    from alink_tpu.common.params import Params
    from alink_tpu.operator.common.linear.mapper import LinearModelMapper
    jt = _jax_table(table)
    m = LinearModelMapper(jt.schema, case["jreq"].schema, Params(PP))
    m.load_model(jt)
    return m


# -- answers ------------------------------------------------------------------

def test_server_answers_bitwise_like_the_jax_package(case):
    """Concurrent single-row requests through the micro-batcher answer
    the JAX package's ``LinearModelMapper.map_table`` labels exactly, and
    its serving path's details and scores bit for bit (the strict
    left-to-right sum; ``map_table``'s BLAS sum differs in the last
    ulps, as the JAX package's own serving path does)."""
    pp = dict(PP, prediction_detail_col="det")
    tm = TMapper(case["tt"].schema, case["treq"].schema, TParams(pp))
    tm.load_model(case["tt"])
    from alink_tpu.common.params import Params
    from alink_tpu.operator.common.linear.mapper import LinearModelMapper
    jm = LinearModelMapper(case["jt"].schema, case["jreq"].schema,
                           Params(pp))
    jm.load_model(case["jt"])
    ref = jm.map_table(case["jreq"])
    from alink_tpu.serving import CompiledPredictor as JPredictor
    jserved = JPredictor(jm).predict_table(case["jreq"])
    pred = CompiledPredictor(tm, device="cpu", ship_dtype=torch.float64)
    rows = [case["treq"].row(i) for i in range(N)]
    with PredictServer(pred, name="bitwise") as srv:
        futs = [srv.submit(r) for r in rows]
        got = [f.result(60) for f in futs]
        st = srv.stats()
    assert [g[1] for g in got] == list(ref.col("pred"))
    assert [g[1] for g in got] == list(jserved.col("pred"))
    assert [str(g[2]) for g in got] == [str(d) for d in jserved.col("det")]
    assert st["requests"] == N and st["failed"] == 0
    assert st["fallback_batches"] == 0 and st["batches"] <= N
    scores = pred.predict_scores(case["treq"])
    np.testing.assert_allclose(scores, jm.predict_scores(case["jreq"]),
                               rtol=1e-13, atol=1e-15)


def test_load_generator_and_serial_baseline(case):
    pred = _predictor(case, "lg")
    rows = [case["treq"].row(i) for i in range(64)]
    with PredictServer(pred, name="lg") as srv:
        rep = LoadGenerator(srv.submit, rows, clients=4, pipeline=8,
                            collect_responses=True).run(400)
        st = srv.stats()
    assert rep.requests == 400 and rep.failures == 0 and rep.timeouts == 0
    assert len(rep.responses) == 400 and rep.qps > 0
    assert rep.p99_s >= rep.p50_s > 0
    assert 0 < st["mean_occupancy"] <= 1 and st["bucket_hit_rate"] > 0.5
    ser = serial_qps(pred, rows, requests=20)
    assert ser.requests == 20 and ser.failures == 0
    assert sorted(rep.summary()) == ["failures", "p50_ms", "p99_ms", "qps",
                                     "requests"]


# -- bucket accounting ----------------------------------------------------------

SIZES = (1, 3, 8, 9, 1, 40, 600, 8, 33)


def _cache_trace(pred, req, swap_tables):
    out = []
    for k, n in enumerate(SIZES):
        pred.predict_table(req.first_n(n))
        if k == 4 and swap_tables:
            pred.swap_model(swap_tables[0])
        if k == 6 and len(swap_tables) > 1:
            pred.swap_model(swap_tables[1])
        out.append(pred.cache_stats())
    return out


def _jax_swap_signature(pred):
    return pred.plan.with_signature(
        pred._active.kernel.signature).swap_signature()


@pytest.mark.parametrize("swaps", ["none", "same_geometry", "new_geometry"])
def test_cache_stats_equal_the_jax_package(case, swaps):
    """A (signature, kind, bucket, trailing shape) key counts a miss at
    its first dispatch and a hit after that: the JAX package's program
    cache counts on the same sequence, a same-geometry swap reusing its
    keys and a new geometry minting its own."""
    from alink_tpu.serving import CompiledPredictor as JPredictor
    from alink_tpu_torch.model.interop import linear_model_from_numpy
    from alink_tpu_torch.operator.common.linear.base import \
        LinearModelDataConverter
    tables = []
    if swaps != "none":
        rng = np.random.RandomState(3)
        t2 = LinearModelDataConverter("LONG").save_model(
            linear_model_from_numpy(rng.randn(D + 1), has_intercept=True,
                                    label_values=[1, 0], vector_col="vec",
                                    vector_size=D, label_type="LONG"))
        tables = [t2]
        if swaps == "new_geometry":
            tables.append(LinearModelDataConverter("LONG").save_model(
                linear_model_from_numpy(
                    rng.randn(2 * D + 1), has_intercept=True,
                    label_values=[1, 0], vector_col="vec",
                    vector_size=2 * D, label_type="LONG")))
    tpred = _predictor(case, "cache")
    jpred = JPredictor(case["jm"], name="cache")
    before = tpred.swap_signature, _jax_swap_signature(jpred)
    port = _cache_trace(tpred, case["treq"], tables)
    jax_side = _cache_trace(jpred, case["jreq"],
                            [_jax_table(t) for t in tables])
    assert port == jax_side
    # a swap keeps the serving geometry's signature unless it changes
    # the geometry, in both packages
    moved = (tpred.swap_signature != before[0],
             _jax_swap_signature(jpred) != before[1])
    assert moved == ((swaps == "new_geometry"),) * 2
    assert port[0] == {"hits": 0, "misses": 1, "programs": 1}
    # buckets 1, 8, 32, 128 and 512; the wider model's 8 and 128 again
    assert port[-1]["programs"] == (7 if swaps == "new_geometry" else 5)


# -- hot swap ---------------------------------------------------------------------

def _jax_snapshots(case):
    from alink_tpu.operator.stream.onlinelearning.ftrl import \
        FtrlTrainStreamOp
    from alink_tpu.operator.stream.source.sources import MemSourceStreamOp
    op = FtrlTrainStreamOp(case["warm"], ml_environment_id=case["sid"],
                           **FTRL_KW).link_from(
        MemSourceStreamOp(case["jtbl"], batch_size=MICRO,
                          ml_environment_id=case["sid"]))
    return [t for t, _ in op.timed_batches()]


def _port_ftrl(case):
    return TFtrl(TMem(case["tt"]), device="cpu", ship_dtype=torch.float64,
                 **FTRL_KW).link_from(
        TMemStream(case["ttbl"], batch_size=MICRO))


def test_hot_swap_tears_nothing_and_swaps_like_the_jax_ftrl(case):
    pred = _predictor(case, "swap")
    probe = case["treq"].row(0)
    with PredictServer(pred, name="swap") as srv:
        lg = LoadGenerator(srv.submit, [probe], clients=4, pipeline=8,
                           collect_responses=True)
        before = lg.run(200)
        feeder = ModelStreamFeeder(srv, _port_ftrl(case)).start()
        during = lg.run(400)
        swaps = feeder.join(timeout=120)
        after = lg.run(200)
        st = srv.stats()
    expected = {repr(tuple(case["tm"].map_row(probe)))}
    for _v, table in feeder.versions:
        m = TMapper(table.schema, case["treq"].schema, TParams(PP))
        m.load_model(table)
        expected.add(repr(tuple(m.map_row(probe))))
        # each swapped-in table loads in the JAX package's mapper and
        # answers the same rows
        jm = _jax_mapper(case, table)
        assert list(jm.map_table(case["jreq"]).col("pred")) == \
            list(m.map_table(case["treq"]).col("pred"))
        assert np.array_equal(_bits(jm.predict_scores(case["jreq"])),
                              _bits(m.predict_scores(case["treq"])))
    observed = {repr(tuple(r)) for rep in (before, during, after)
                for r in rep.responses}
    assert observed <= expected                       # no torn response
    assert swaps == len(_jax_snapshots(case)) == len(feeder.versions)
    assert st["model_version"] == swaps + 1
    assert before.failures + during.failures + after.failures == 0
    assert st["failed"] == 0 and st["fallback_batches"] == 0


def test_device_weights_feeder_serves_like_the_model_stream(case):
    """The device path swaps the same weights as the host-table path:
    after every swap the served scores are bitwise equal."""
    rows = case["treq"].first_n(16)
    host_scores, dev_scores = [], []
    pred_h = _predictor(case, "host")
    with PredictServer(pred_h, name="host") as srv:
        fh = ModelStreamFeeder(
            srv, _port_ftrl(case),
            on_swap=lambda v, t: host_scores.append(
                pred_h.predict_scores(rows)))
        n_host = fh.run()
    pred_d = _predictor(case, "dev")
    with PredictServer(pred_d, name="dev") as srv:
        fd = DeviceWeightsFeeder(
            srv, _port_ftrl(case),
            on_swap=lambda v: dev_scores.append(
                pred_d.predict_scores(rows)))
        n_dev = fd.start().join(timeout=120)
        last = srv.predict(case["treq"].row(1), timeout=60)
    assert n_host == n_dev == len(_jax_snapshots(case)) > 2
    for a, b in zip(host_scores, dev_scores):
        assert np.array_equal(_bits(a), _bits(b))
    assert pred_d.model_version == n_dev + 1 and fd.skipped == 0
    assert last == tuple(pred_h.predict_row(case["treq"].row(1)))


def test_device_weights_feeder_refuses_a_wider_trainer(case):
    """A trainer wider than the served kernel refuses loudly (recorded
    once as fatal), the server keeps the last good model."""
    from alink_tpu_torch.model.interop import linear_model_from_numpy
    from alink_tpu_torch.operator.common.linear.base import \
        LinearModelDataConverter
    wide = LinearModelDataConverter("LONG").save_model(
        linear_model_from_numpy(np.zeros(2 * 64 + 1), has_intercept=True,
                                label_values=[1, 0], vector_col="vec",
                                vector_size=2 * 64, label_type="LONG"))
    X = np.random.RandomState(1).randn(64, 2 * 64)
    v = np.empty(64, object)
    v[:] = [TDense(x) for x in X]
    tbl = TMTable({"vec": v, "label": (X[:, 0] > 0).astype(np.int64)},
                  "vec VECTOR, label LONG")
    ftrl = TFtrl(TMem(wide), device="cpu", ship_dtype=torch.float64,
                 **FTRL_KW).link_from(TMemStream(tbl, batch_size=MICRO))
    pred = _predictor(case, "wide")
    with PredictServer(pred, name="wide") as srv:
        feeder = DeviceWeightsFeeder(srv, ftrl).start()
        with pytest.raises(ValueError, match="geometry mismatch"):
            feeder.join(timeout=60)
        assert pred.model_version == 1
    assert get_registry().value(
        "alink_serve_feeder_errors_total",
        {"feeder": "DeviceWeightsFeeder", "kind": "fatal"}) == 1


def test_swap_weights_checks_geometry_and_sync_mode(case, monkeypatch):
    pred = _predictor(case, "sw")
    kern = pred._active.kernel
    w, b = (a.clone() for a in kern.model_arrays)
    with pytest.raises(ValueError, match="geometry mismatch"):
        pred.swap_weights((w[:-8], b))
    with pytest.raises(ValueError, match="arrays"):
        pred.swap_weights((w,))
    with pytest.raises(ValueError, match="geometry mismatch"):
        pred.swap_weights((w.float(), b))
    monkeypatch.setenv("ALINK_TPU_SERVE_SWAP", "sync")
    before = pred.predict_scores(case["treq"].first_n(5))
    assert pred.swap_weights((w * 2, b * 2)) == 2
    assert np.array_equal(_bits(pred.predict_scores(
        case["treq"].first_n(5))), _bits(2 * before))
    assert get_registry().value("alink_serve_model_swaps_total",
                                {"predictor": "sw"}) == 1


# -- chaos ------------------------------------------------------------------------

def test_small_chaos_run_drops_nothing_and_recovers(case, monkeypatch):
    """``bench.py``'s serve_chaos storm at a CPU size: an error window at
    ``serve.dispatch`` with a corrupt first FTRL snapshot during a swap
    storm, then injected latency with 4 ms deadlines, then recovery."""
    monkeypatch.setenv("ALINK_TPU_SERVE_BREAKER_MAX_MS", "200")
    pred = _predictor(case, "chaos")
    srv = PredictServer(pred, name="chaos")
    probe = case["treq"].row(0)
    tally = {"submitted": 0, "results": 0, "typed": 0, "silent": 0}
    responses = []

    def lg(requests):
        rep = LoadGenerator(srv.submit, [probe], clients=4, pipeline=8,
                            collect_responses=True).run(requests)
        tally["submitted"] += rep.requests
        tally["results"] += rep.requests - rep.failures
        tally["typed"] += rep.failures - rep.timeouts
        tally["silent"] += rep.timeouts
        responses.extend(rep.responses)
        return rep

    def settle(futs):
        for f in futs:
            try:
                responses.append(tuple(f.result(60)))
                tally["results"] += 1
            except TimeoutError:
                tally["silent"] += 1
            except Exception:
                tally["typed"] += 1

    try:
        lg(100)
        with scoped_fault_env("serve.dispatch:1-14:error;"
                              "feeder.snapshot:1-1:corrupt"):
            feeder = ModelStreamFeeder(srv, _port_ftrl(case)).start()
            lg(200)
            wait_until = time.monotonic() + 20
            while srv.breaker_stats()["state"] != "closed" \
                    and time.monotonic() < wait_until:
                tally["submitted"] += 1
                settle([srv.submit(probe)])
                time.sleep(0.05)
            # the same visit counters: the corrupt window stays
            # exactly-once (the scope restores the variable on exit)
            os.environ["ALINK_TPU_FAULT_INJECT"] = \
                "serve.dispatch:1:delay:30;feeder.snapshot:1-1:corrupt"
            first = srv.submit(probe)
            time.sleep(0.01)
            shed = [srv.submit(probe, deadline_s=0.004) for _ in range(6)]
            tally["submitted"] += 7
            settle([first] + shed)
            swaps = feeder.join(timeout=120)
        assert "ALINK_TPU_FAULT_INJECT" not in os.environ
        reset_faults()
        time.sleep(0.25)
        pre = srv.stats()
        lg(200)
        st = srv.stats()
    finally:
        srv.close()
    compiled_after = (st["batches"] - pre["batches"]) \
        - (st["fallback_batches"] - pre["fallback_batches"])
    expected = {repr(tuple(case["tm"].map_row(probe)))}
    for _v, table in feeder.versions:
        m = TMapper(table.schema, case["treq"].schema, TParams(PP))
        m.load_model(table)
        expected.add(repr(tuple(m.map_row(probe))))
    assert tally["silent"] == 0
    assert tally["results"] + tally["typed"] == tally["submitted"]
    assert tally["typed"] > 0 and st["shed"] >= 6
    assert {repr(tuple(r)) for r in responses} <= expected    # none torn
    assert st["breaker"]["opens"] >= 1 and st["breaker"]["state"] == "closed"
    assert compiled_after > 0
    assert feeder.skipped == 1 and swaps == len(_jax_snapshots(case)) - 1


# -- ModelMapStreamOp's compiled route ------------------------------------------

def _drain(op):
    return [mt for _t, mt in op.timed_batches()]


def test_compiled_stream_route_answers_like_the_host_route(case,
                                                           monkeypatch):
    """``ALINK_TPU_SERVE_COMPILED`` routes the twin's micro-batches
    through ``CompiledPredictor`` (float32 on its device): its labels
    are the host route's (float64) outside the float32 rounding band.
    A micro-batch the kernel refuses (a ``GeometryRefused`` from its
    encode, here scripted for the last one) serves through the host
    mapper, recorded once per batch."""
    from alink_tpu_torch.operator.stream.predict_ops import \
        LogisticRegressionPredictStreamOp
    X = case["X"]
    last = case["treq"].row(N - MICRO)[0]
    real = CompiledPredictor.predict_table

    def refusing(self, data):
        if data.col("vec")[0] is last:
            raise GeometryRefused("request geometry refused")
        return real(self, data)
    monkeypatch.setattr(CompiledPredictor, "predict_table", refusing)

    def run():
        return _drain(LogisticRegressionPredictStreamOp(
            TMem(case["tt"]), device="cpu", **PP).link_from(
            TMemStream(case["treq"], batch_size=MICRO)))
    host = run()
    monkeypatch.setenv("ALINK_TPU_SERVE_COMPILED", "1")
    with pytest.warns(RuntimeWarning, match="geometry-refused"):
        dev = run()
    assert len(host) == len(dev) == N // MICRO
    coef = np.asarray(case["tm"].model.coef)
    band = 1e-6 * (np.abs(X) @ np.abs(coef[1:]) + abs(coef[0]))
    outside = np.abs(X @ coef[1:] + coef[0]) > band
    got = np.concatenate([np.asarray(mt.col("pred")) for mt in dev])
    ref = np.concatenate([np.asarray(mt.col("pred")) for mt in host])
    assert outside.mean() > 0.9
    assert np.array_equal(got[outside], ref[outside])
    assert list(dev[-1].col("pred")) == list(host[-1].col("pred"))
    reg = get_registry()
    assert reg.value("alink_serve_fallback_total", {
        "mapper": "LinearModelMapper", "reason": "geometry-refused"}) == 1
    assert reg.value("alink_serve_batches_total", {
        "predictor": "LogisticRegressionPredictStreamOp"}) == N // MICRO - 1


def _wider_rows(case, extra=3):
    X = np.random.RandomState(3).randn(4, D + extra)
    v = np.empty(4, object)
    v[:] = [TDense(x) for x in X]
    return TMTable({"vec": v}, "vec VECTOR")


def test_encode_refuses_a_wider_request_as_geometry(case):
    """The encode's geometry refusal is its own type, the one error the
    compiled stream route serves around; it is still a ``ValueError``."""
    pred = _predictor(case, "wide_req")
    with pytest.raises(GeometryRefused, match="features"):
        pred.predict_table(_wider_rows(case))
    assert issubclass(GeometryRefused, ValueError)


@pytest.mark.parametrize("err", [
    ValueError("dense_scores: every tensor must be contiguous"),
    RuntimeError("serve_dense: kernel launch failed: CUDA error 700")])
def test_compiled_stream_route_raises_a_kernel_error(case, monkeypatch, err):
    """An error of the kernel's wrapper is a fault of the compiled route,
    not a refused geometry: the stream fails with it, and nothing is
    served through the host mapper."""
    from alink_tpu_torch.kernels import serve as kserve
    from alink_tpu_torch.operator.stream.predict_ops import \
        LogisticRegressionPredictStreamOp

    def failing(model, X, dtype):
        raise err
    monkeypatch.setattr(kserve, "dense_scores", failing)
    monkeypatch.setenv("ALINK_TPU_SERVE_COMPILED", "1")
    with pytest.raises(type(err), match=str(err)[:20]):
        _drain(LogisticRegressionPredictStreamOp(
            TMem(case["tt"]), device="cpu", **PP).link_from(
            TMemStream(case["treq"].first_n(2 * MICRO), batch_size=MICRO)))
    assert get_registry().value("alink_serve_fallback_total", {
        "mapper": "LinearModelMapper", "reason": "geometry-refused"}) == 0


@pytest.mark.parametrize("err", [
    ValueError("dense_scores: tensors on cpu; the kernel takes cuda"),
    RuntimeError("serve_dense: kernel launch failed: CUDA error 700")])
def test_a_kernel_error_never_opens_the_breaker(case, monkeypatch, err):
    """Only injected faults move the breaker. A kernel wrapper that
    raises fails each of its batches with its own error — at a threshold
    of 1 — and never opens the breaker or serves through the host
    mapper; in the half-open state it fails the probe's batch, frees the
    probe slot and leaves the breaker half-open, so the next batch
    probes again and closes it."""
    from alink_tpu_torch.kernels import serve as kserve
    from alink_tpu_torch.serving.resilience import counts_toward_breaker
    monkeypatch.setenv("ALINK_TPU_SERVE_BREAKER_THRESHOLD", "1")
    monkeypatch.setenv("ALINK_TPU_SERVE_BREAKER_BACKOFF_MS", "10")
    assert not counts_toward_breaker(err)
    row = case["treq"].row(0)
    want = tuple(_predictor(case, "kerr_ref").predict_row(row))
    real = kserve.dense_scores
    broken = {"on": True}

    def maybe_failing(model, X, dtype):
        if broken["on"]:
            raise err
        return real(model, X, dtype)
    monkeypatch.setattr(kserve, "dense_scores", maybe_failing)
    pred = _predictor(case, "kerr")
    with PredictServer(pred, name="kerr") as srv:
        for _ in range(4):
            with pytest.raises(type(err)):
                srv.submit(row).result(60)
        st = srv.stats()
        assert st["breaker"]["state"] == "closed"
        assert st["breaker"]["opens"] == 0
        assert st["fallback_batches"] == 0 and st["failed"] == 4
        # an injected fault opens it; the probe then meets the kernel
        # error, which neither re-opens nor serves around it
        with scoped_fault_env("serve.dispatch:1-1:error"):
            with pytest.raises(Exception, match="transient fault"):
                srv.submit(row).result(60)
        assert srv.breaker_stats()["opens"] == 1
        time.sleep(0.05)
        with pytest.raises(type(err)):
            srv.submit(row).result(60)
        st = srv.stats()
        assert st["breaker"]["state"] == "half-open"
        assert st["breaker"]["reopens"] == 0 and st["fallback_batches"] == 0
        broken["on"] = False
        assert srv.submit(row).result(60) == want
        st = srv.stats()
        assert st["breaker"]["state"] == "closed"
        assert st["breaker"]["probes"] == 2 and st["failed"] == 6


# -- the card by default ----------------------------------------------------------

def test_entry_points_raise_without_cuda(case, monkeypatch):
    from alink_tpu_torch.operator.stream.predict_ops import \
        LogisticRegressionPredictStreamOp
    from alink_tpu_torch.operator.stream.utils import ModelMapStreamOp
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        CompiledPredictor(case["tm"])
    with pytest.raises(RuntimeError, match="CUDA"):
        CompiledPredictor.for_mapper(case["tm"])
    with pytest.raises(RuntimeError, match="CUDA"):
        LogisticRegressionPredictStreamOp(TMem(case["tt"]), **PP)
    with pytest.raises(RuntimeError, match="CUDA"):
        TFtrl(TMem(case["tt"]), **FTRL_KW)
    monkeypatch.setenv("ALINK_TPU_SERVE_COMPILED", "1")
    op = ModelMapStreamOp(TMem(case["tt"]), TParams(PP),
                          mapper_cls=TMapper).link_from(
        TMemStream(case["treq"].first_n(8), batch_size=8))
    with pytest.raises(RuntimeError, match="CUDA"):
        _drain(op)
    pred = CompiledPredictor(case["tm"], device="cpu")
    with pytest.raises(NotImplementedError, match="replicas"):
        PredictServer(pred, replicas=2)
