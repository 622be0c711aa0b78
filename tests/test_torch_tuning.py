"""The port's grid searches (``alink_tpu_torch/pipeline/tuning.py``) on
the CPU, against the JAX package's on the fixtures of
``tests/test_tuning.py``.

The JAX package's default environment is a 1-device one while the
module runs, and it trains in float64 (x64); the port's estimators
train on the CPU in float64 (``device="cpu", dtype=torch.float64``).
Contracts:

* each candidate's score within 1e-10 of the JAX package's, the same
  winner, and the winning model's coefficients within rtol 1e-10 (atol
  1e-12) with the same predicted labels;
* ``ALINK_TPU_SWEEP`` on and off give the identical report and models;
* each fallback (unsupported estimator, unsupported evaluator,
  trace-shaping axis) is recorded once a reason, and the serial loop
  still answers;
* with the flag off ``alink_tpu_torch.tuning.sweep`` is never imported;
* an error inside the sweep propagates out of ``fit``; it never turns
  into a serial run (the JAX package's ``sweep-error`` fallback is not
  ported).
"""

import subprocess
import sys
import warnings
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from alink_tpu_torch.common.metrics import MetricsRegistry, set_registry
from alink_tpu_torch.common.vector import DenseVector
from alink_tpu_torch.operator.batch.source import MemSourceBatchOp
from alink_tpu_torch.pipeline import (BinaryClassificationTuningEvaluator,
                                      ClusterTuningEvaluator, GridSearchCV,
                                      GridSearchTVSplit, ParamGrid,
                                      RegressionTuningEvaluator, Report)
from alink_tpu_torch.pipeline.base import Pipeline
from alink_tpu_torch.pipeline.classification import LogisticRegression
from alink_tpu_torch.pipeline.clustering import KMeans
from alink_tpu_torch.pipeline.regression import LinearRegression
from alink_tpu_torch.tuning.sweep import _reset_fallback_warnings

F64 = dict(device="cpu", dtype=torch.float64)


@pytest.fixture(scope="module", autouse=True)
def jax_one_device():
    from alink_tpu.common.mlenv import MLEnvironment, MLEnvironmentFactory
    prev = MLEnvironmentFactory.get_default()
    MLEnvironmentFactory.set_default(
        MLEnvironment(parallelism=1, devices=jax.devices()[:1]))
    yield
    MLEnvironmentFactory.set_default(prev)


@pytest.fixture
def fresh_registry():
    reg = MetricsRegistry()
    prev = set_registry(reg)
    try:
        yield reg
    finally:
        set_registry(prev)


@pytest.fixture
def sweep_on(monkeypatch):
    monkeypatch.setenv("ALINK_TPU_SWEEP", "1")


def _binary_rows(n=240, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 3)
    y = (X @ np.asarray([2.0, -1.0, 0.5]) + 0.3 * rng.randn(n) > 0
         ).astype(int)
    return [tuple(x) + (int(t),) for x, t in zip(X, y)]


BIN_SCHEMA = "f0 DOUBLE, f1 DOUBLE, f2 DOUBLE, label INT"


def _regression_rows():
    rng = np.random.RandomState(3)
    X = rng.randn(200, 2)
    y = X @ np.asarray([1.5, -2.0]) + 0.1 * rng.randn(200)
    return [tuple(x) + (float(t),) for x, t in zip(X, y)]


REG_SCHEMA = "a DOUBLE, b DOUBLE, y DOUBLE"


def _cv(pkg, max_iter=30, axes=(("l2", [0.0001, 100.0]),), **kw):
    """``test_grid_search_cv_binary``'s search in either package."""
    if pkg == "jax":
        from alink_tpu.pipeline import (
            BinaryClassificationTuningEvaluator as Ev,
            GridSearchCV as CV, ParamGrid as Grid)
        from alink_tpu.pipeline.classification import (
            LogisticRegression as LR)
        kw = {}
    else:
        Ev, CV, Grid, LR = (BinaryClassificationTuningEvaluator,
                            GridSearchCV, ParamGrid, LogisticRegression)
        kw = dict(F64, **kw)
    lr = LR(feature_cols=["f0", "f1", "f2"], label_col="label",
            prediction_col="pred", prediction_detail_col="details",
            max_iter=max_iter, **kw)
    grid = Grid()
    for name, vals in axes:
        grid.add_grid(lr, name, vals)
    return CV(estimator=lr, param_grid=grid,
              tuning_evaluator=Ev(label_col="label",
                                  prediction_detail_col="details"),
              num_folds=3, seed=1)


def _tv(pkg, pipeline=True):
    """``test_grid_search_tv_split_regression_pipeline``'s search."""
    if pkg == "jax":
        from alink_tpu.pipeline import (
            GridSearchTVSplit as TV, ParamGrid as Grid,
            RegressionTuningEvaluator as Ev)
        from alink_tpu.pipeline.base import Pipeline as Pipe
        from alink_tpu.pipeline.regression import LinearRegression as Reg
        kw = {}
    else:
        TV, Grid, Ev, Pipe, Reg = (GridSearchTVSplit, ParamGrid,
                                   RegressionTuningEvaluator, Pipeline,
                                   LinearRegression)
        kw = F64
    reg = Reg(feature_cols=["a", "b"], label_col="y", prediction_col="pred",
              **kw)
    grid = Grid().add_grid(reg, "l2", [0.0, 1000.0])
    return TV(estimator=Pipe(reg) if pipeline else reg, param_grid=grid,
              tuning_evaluator=Ev(label_col="y", prediction_col="pred",
                                  tuning_regression_metric="RMSE"),
              train_ratio=0.75, seed=5)


def _jsrc(rows, schema):
    from alink_tpu.operator.batch.source import MemSourceBatchOp as JMem
    return JMem(rows, schema)


def _coef(model, pkg):
    """The coefficients of a fitted linear model's table."""
    if pkg == "jax":
        from alink_tpu.operator.common.linear.base import (
            LinearModelDataConverter as Conv)
    else:
        from alink_tpu_torch.operator.common.linear.base import (
            LinearModelDataConverter as Conv)
    return np.asarray(Conv.load_table(model.get_model_data()).coef,
                      np.float64)


def _assert_same_search(tm, jm, src_t, src_j, label_col):
    assert tm.best_params_desc == jm.best_params_desc
    assert [r[0] for r in tm.report.rows] == [r[0] for r in jm.report.rows]
    for (_, tv, tok, _), (_, jv, jok, _) in zip(tm.report.rows,
                                                jm.report.rows):
        assert tok and jok
        assert abs(tv - jv) <= 1e-10, (tv, jv)
    tout = tm.transform(src_t).get_output_table()
    jout = jm.transform(src_j).get_output_table()
    assert list(tout.col(label_col)) == list(jout.col(label_col))
    return tout, jout


def test_grid_search_cv_binary_matches_the_jax_package():
    rows = _binary_rows()
    src, jsrc = MemSourceBatchOp(rows, BIN_SCHEMA), _jsrc(rows, BIN_SCHEMA)
    tm, jm = _cv("port").fit(src), _cv("jax").fit(jsrc)
    assert "l2=0.0001" in tm.best_params_desc
    tout, jout = _assert_same_search(tm, jm, src, jsrc, "pred")
    np.testing.assert_allclose(_coef(tm.best_model, "port"),
                               _coef(jm.best_model, "jax"),
                               rtol=1e-10, atol=1e-12)
    acc = (np.asarray(tout.col("pred")) == np.asarray(tout.col("label"))
           ).mean()
    assert acc > 0.9
    report = tm.report.to_mtable()
    assert report.num_rows == 2
    assert report.col_names == ["params", "metric", "success", "message"]


def test_grid_search_tv_split_regression_pipeline_matches_the_jax_package():
    rows = _regression_rows()
    src, jsrc = MemSourceBatchOp(rows, REG_SCHEMA), _jsrc(rows, REG_SCHEMA)
    tm, jm = _tv("port").fit(src), _tv("jax").fit(jsrc)
    assert "l2=0.0" in tm.best_params_desc
    tout, jout = tm.transform(src).get_output_table(), \
        jm.transform(jsrc).get_output_table()
    for (_, tv, tok, _), (_, jv, jok, _) in zip(tm.report.rows,
                                                jm.report.rows):
        assert tok and jok and abs(tv - jv) <= 1e-10 * max(1.0, abs(jv))
    assert tm.best_params_desc == jm.best_params_desc
    np.testing.assert_allclose(np.asarray(tout.col("pred"), np.float64),
                               np.asarray(jout.col("pred"), np.float64),
                               rtol=1e-10, atol=1e-12)
    rmse = float(np.sqrt(np.mean((np.asarray(tout.col("pred"))
                                  - np.asarray(tout.col("y"))) ** 2)))
    assert rmse < 0.5


@pytest.mark.parametrize("search", ["cv_binary", "tv_regression",
                                    "tv_regression_pipeline",
                                    "cv_binary_l1_crossing_zero"])
def test_flag_on_report_and_models_identical(search, monkeypatch,
                                             fresh_registry):
    """The sweep's report, winner and refit model are the serial loop's,
    bit for bit; a supported grid records no fallback."""
    if search.startswith("cv_binary"):
        rows, schema, col = _binary_rows(seed=2), BIN_SCHEMA, "details"
        axes = (("l2", [0.0001, 0.5, 100.0]),) if search == "cv_binary" \
            else (("l1", [0.0, 0.01]), ("l2", [0.0001, 1.0]))

        def make():
            return _cv("port", max_iter=10, axes=axes)
    else:
        rows, schema, col = _regression_rows(), REG_SCHEMA, "pred"

        def make():
            return _tv("port", pipeline=search.endswith("pipeline"))
    src = MemSourceBatchOp(rows, schema)
    monkeypatch.delenv("ALINK_TPU_SWEEP", raising=False)
    off = make().fit(src)
    monkeypatch.setenv("ALINK_TPU_SWEEP", "1")
    on = make().fit(src)
    assert on.best_params_desc == off.best_params_desc
    assert on.report.rows == off.report.rows
    a = on.transform(src).get_output_table()
    b = off.transform(src).get_output_table()
    assert a.to_rows() == b.to_rows()
    fallbacks = [r for r in fresh_registry.snapshot()
                 if r["name"] == "alink_sweep_fallback_total"]
    if search == "tv_regression_pipeline":
        assert [r["labels"]["reason"] for r in fallbacks] == \
            ["unsupported-estimator"]
    else:
        assert not fallbacks


def test_flag_off_never_imports_the_sweep():
    code = (
        "import sys, torch\n"
        "from alink_tpu_torch.operator.batch.source import MemSourceBatchOp\n"
        "from alink_tpu_torch.pipeline import (GridSearchTVSplit, ParamGrid,"
        " BinaryClassificationTuningEvaluator)\n"
        "from alink_tpu_torch.pipeline.classification import "
        "LogisticRegression\n"
        "rows = [(float(i % 7), float(i % 3), i % 2) for i in range(60)]\n"
        "src = MemSourceBatchOp(rows, 'a DOUBLE, b DOUBLE, label INT')\n"
        "lr = LogisticRegression(feature_cols=['a', 'b'], label_col='label',"
        " prediction_detail_col='d', prediction_col='p', max_iter=3,"
        " device='cpu')\n"
        "tv = GridSearchTVSplit(estimator=lr, param_grid=ParamGrid()"
        ".add_grid(lr, 'l2', [0.1, 1.0]), tuning_evaluator="
        "BinaryClassificationTuningEvaluator(label_col='label',"
        " prediction_detail_col='d'), train_ratio=0.5)\n"
        "tv.fit(src)\n"
        "bad = [k for k in sys.modules if k.startswith("
        "'alink_tpu_torch.tuning')]\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in __import__("os").environ.items()
           if k != "ALINK_TPU_SWEEP"}
    res = subprocess.run([sys.executable, "-c", code],
                         cwd=Path(__file__).resolve().parents[1],
                         capture_output=True, text=True, timeout=300,
                         env=env)
    assert res.returncode == 0, res.stdout + res.stderr


def test_flag_off_never_reaches_the_sweep_path(monkeypatch):
    import alink_tpu_torch.pipeline.tuning as pt
    monkeypatch.delenv("ALINK_TPU_SWEEP", raising=False)

    def boom(self, table):   # pragma: no cover - must not run
        raise AssertionError("flag-off reached _sweep_fit")
    monkeypatch.setattr(pt.BaseGridSearch, "_sweep_fit", boom)
    _cv("port", max_iter=4).fit(MemSourceBatchOp(_binary_rows(seed=2),
                                                 BIN_SCHEMA))


def _fallback_counts(reg):
    return {(r["labels"]["estimator"], r["labels"]["reason"]): r["value"]
            for r in reg.snapshot()
            if r["name"] == "alink_sweep_fallback_total"}


def _km_search():
    rng = np.random.RandomState(4)
    X = np.concatenate([rng.randn(40, 3) + c for c in (0.0, 6.0)])
    src = MemSourceBatchOp([(DenseVector(x),) for x in X], "vec VECTOR")
    km = KMeans(vector_col="vec", prediction_col="pred", k=2, max_iter=3,
                init_mode="RANDOM", device="cpu")
    tv = GridSearchTVSplit(
        estimator=km, param_grid=ParamGrid().add_grid(km, "k", [2, 3]),
        tuning_evaluator=ClusterTuningEvaluator(vector_col="vec"),
        train_ratio=0.8, seed=1)
    return tv, src


class _MyEval(BinaryClassificationTuningEvaluator):
    pass


@pytest.mark.parametrize("reason", ["unsupported-estimator",
                                    "unsupported-evaluator",
                                    "trace-shaping-axis"])
def test_fallbacks_recorded_once_per_reason(reason, sweep_on,
                                            fresh_registry):
    """Each fallback counts every time and warns once; the serial loop
    still runs and gives the flag-off report."""
    _reset_fallback_warnings()
    if reason == "unsupported-estimator":
        make = _km_search
        est = "KMeans"
    else:
        def make():
            tv = _cv("port", max_iter=4,
                     axes=(("max_iter", [3, 4]),)
                     if reason == "trace-shaping-axis"
                     else (("l2", [0.1, 1.0]),))
            if reason == "unsupported-evaluator":
                tv.tuning_evaluator = _MyEval(
                    label_col="label", prediction_detail_col="details")
            return tv, MemSourceBatchOp(_binary_rows(seed=3), BIN_SCHEMA)
        est = "LogisticRegression"
    tv, src = make()
    with pytest.warns(RuntimeWarning, match=reason):
        m = tv.fit(src)
    tv, src = make()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        m2 = tv.fit(src)
    assert m.best_params_desc and m.report.rows == m2.report.rows
    assert _fallback_counts(fresh_registry) == {(est, reason): 2}
    _reset_fallback_warnings()


def test_sweep_error_propagates(sweep_on, monkeypatch):
    """An error inside the sweep leaves ``fit``; no serial candidate fit
    runs in its place."""
    import alink_tpu_torch.tuning.sweep as sw

    class KernelFailed(RuntimeError):
        pass

    def fail(*a, **k):
        raise KernelFailed("kernel did not launch")
    monkeypatch.setattr(sw, "sweep_optimize", fail)
    fits = []
    real_fit = LogisticRegression.fit
    monkeypatch.setattr(LogisticRegression, "fit",
                        lambda self, op: fits.append(1) or
                        real_fit(self, op))
    with pytest.raises(KernelFailed):
        _cv("port", max_iter=4).fit(MemSourceBatchOp(_binary_rows(seed=4),
                                                     BIN_SCHEMA))
    assert not fits


@pytest.mark.parametrize("flag", ["0", "1"])
def test_failed_candidate_is_recorded_in_the_report(flag, monkeypatch):
    """A candidate whose scoring fails is a failed row of the Report in
    both paths; the others still compete."""
    monkeypatch.setenv("ALINK_TPU_SWEEP", flag)
    calls = []
    real = BinaryClassificationTuningEvaluator.evaluate

    def flaky(self, op):
        calls.append(1)
        if len(calls) == 1:
            raise ValueError("scoring failed")
        return real(self, op)
    monkeypatch.setattr(BinaryClassificationTuningEvaluator, "evaluate",
                        flaky)
    m = _cv("port", max_iter=4).fit(MemSourceBatchOp(_binary_rows(seed=5),
                                                     BIN_SCHEMA))
    ok = [r[2] for r in m.report.rows]
    assert ok == [False, True]
    assert "ValueError: scoring failed" in m.report.rows[0][3]
    assert np.isnan(m.report.rows[0][1])
    assert "l2=100.0" in m.best_params_desc


def test_all_candidates_failing_raises(monkeypatch):
    monkeypatch.setattr(BinaryClassificationTuningEvaluator, "evaluate",
                        lambda self, op: 1 / 0)
    with pytest.raises(RuntimeError, match="all tuning candidates failed"):
        _cv("port", max_iter=3).fit(MemSourceBatchOp(_binary_rows(seed=5),
                                                     BIN_SCHEMA))


def test_param_grid_and_report():
    lr = LogisticRegression(feature_cols=["f0"], label_col="label",
                            device="cpu")
    grid = ParamGrid().add_grid(lr, "l2", [0.1]).add_grid(lr, "maxIter",
                                                          [3])
    assert [(pi.name, v) for _, pi, v in grid.items] == \
        [("l2", [0.1]), ("max_iter", [3])]
    with pytest.raises(KeyError):
        ParamGrid().add_grid(lr, "momentum", [1])
    rep = Report([("a", 1.5, True, ""), ("b", float("nan"), False, "x")])
    assert rep.to_mtable().num_rows == 2
    assert "ERR" in repr(rep)


def test_trainer_dtype_reaches_the_train_op():
    """``dtype=`` (not a param) rides ``clone()`` and the train op: the
    estimator's model is the float64 train op's."""
    from alink_tpu_torch.operator.batch.classification.linear import (
        LogisticRegressionTrainBatchOp)
    rows = _binary_rows(n=80, seed=6)
    src = MemSourceBatchOp(rows, BIN_SCHEMA)
    kw = dict(feature_cols=["f0", "f1", "f2"], label_col="label",
              max_iter=5)
    lr = LogisticRegression(**kw, **F64)
    assert lr.clone().dtype == torch.float64 and "dtype" not in \
        lr.get_params().to_json()
    op = LogisticRegressionTrainBatchOp(**kw, **F64).link_from(src)
    assert lr.fit(src).get_model_data().to_rows() == \
        op.get_output_table().to_rows()
    assert LogisticRegression(**kw, device="cpu").fit(src) \
        .get_model_data().to_rows() != op.get_output_table().to_rows()
