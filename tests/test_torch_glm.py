"""Slice 23 of the port: GLM, isotonic and AFT regression on the CPU
against the JAX package.

The JAX side runs under x64 on a 1-device default session, the port with
``device="cpu"`` and ``dtype=torch.float64``. Tolerances:

* IRLS (``GlmTrainBatchOp``) for every family with its own labels and
  links (gaussian/identity, binomial/logit, poisson/log, gamma/log,
  gamma/inverse, tweedie/log, poisson/sqrt), with row weights and a
  ridge term: equal step counts first, then beta within rtol 1e-10;
* ``GlmPredictBatchOp``: the linear predictor equal (host numpy in both
  packages), the mean within rtol 1e-14 (the inverse link, torch against
  XLA); ``GlmEvaluationBatchOp``: the summary equal;
* ``pav`` and ``IsotonicRegTrainBatchOp`` (host numpy, a copy): the
  boundaries and values equal, the predictions equal;
* AFT (``_AftObjFunc``, gradient by autograd against ``jax.grad``): the
  loss curve over 10 supersteps and the coefficients after 5 within
  rtol 1e-10, the predictions (host numpy) within rtol 1e-10 of the
  JAX package's on its own model and equal on the same table;
* each package's GLM table predicts the same in the other; the pipeline
  stages fit and transform as the ops do.
"""

import json

import jax
import numpy as np
import pytest
import torch

from alink_tpu.common.mlenv import MLEnvironment as JEnv
from alink_tpu.common.mlenv import MLEnvironmentFactory as JFactory
from alink_tpu.common.mtable import MTable as JMTable
from alink_tpu.common.types import TableSchema as JSchema
from alink_tpu.operator.batch.regression import glm_ops as jg
from alink_tpu.operator.batch.source import MemSourceBatchOp as JMem
from alink_tpu.operator.common.optim import optimizers as jopt
from alink_tpu_torch.common.mlenv import MLEnvironment as TEnv
from alink_tpu_torch.model.interop import simple_model_table_from_reference
from alink_tpu_torch.operator.batch.regression import glm_ops as tg
from alink_tpu_torch.operator.batch.source import MemSourceBatchOp as TMem
from alink_tpu_torch.operator.common.optim import optimizers as topt
from alink_tpu_torch.pipeline import (AftSurvivalRegression,
                                      GeneralizedLinearRegression,
                                      IsotonicRegression)

RTOL = 1e-10
D = 4
FEATS = [f"x{j}" for j in range(D)]
SCHEMA = ", ".join(f"{c} DOUBLE" for c in FEATS) + ", y DOUBLE, w DOUBLE"
CASES = (("gaussian", "identity"), ("binomial", "logit"), ("poisson", "log"),
         ("gamma", "log"), ("gamma", "inverse"), ("tweedie", "log"),
         ("poisson", "sqrt"))


@pytest.fixture
def jax_default_1dev():
    prev = JFactory.get_default()
    JFactory.set_default(JEnv(parallelism=1, devices=jax.devices()[:1]))
    yield
    JFactory.set_default(prev)


def _jax_table(t):
    return JMTable(t.to_rows(), JSchema(list(t.schema.names),
                                        list(t.schema.types)))


def family_rows(family, link, n=400, seed=0):
    """Rows with labels drawn from the family's own model at a seeded
    beta (the mean through the link's inverse)."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, D) * 0.5
    beta = np.asarray([0.3, -0.4, 0.2, 0.1])
    eta = X @ beta + {"identity": 1.0, "logit": 0.2, "log": 0.5,
                      "inverse": 2.0, "sqrt": 1.5}[link]
    mu = {"identity": eta, "logit": 1 / (1 + np.exp(-eta)),
          "log": np.exp(eta), "inverse": 1 / eta, "sqrt": eta ** 2}[link]
    if family == "gaussian":
        y = mu + 0.3 * rng.randn(n)
    elif family == "binomial":
        y = (rng.rand(n) < mu).astype(float)
    elif family == "poisson":
        y = rng.poisson(mu).astype(float)
    elif family == "gamma":
        y = rng.gamma(4.0, mu / 4.0)
    else:                       # tweedie: compound Poisson-gamma
        k = rng.poisson(mu)
        y = np.asarray([rng.gamma(2.0, 0.5, c).sum() for c in k])
    w = rng.rand(n) + 0.5
    return [(*map(float, x), float(t), float(v)) for x, t, v in zip(X, y, w)]


def _glm(family, link, rows, **extra):
    kw = dict(feature_cols=FEATS, label_col="y", family=family, link=link,
              max_iter=50, epsilon=1e-8, **extra)
    top = tg.GlmTrainBatchOp(device="cpu", dtype=torch.float64, **kw) \
        .link_from(TMem(rows, SCHEMA))
    jop = jg.GlmTrainBatchOp(**kw).link_from(JMem(rows, SCHEMA))
    return top, jop


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("family,link", CASES)
def test_irls_matches_the_jax_package(family, link, weighted,
                                      jax_default_1dev):
    rows = family_rows(family, link)
    extra = dict(weight_col="w", reg_param=0.01) if weighted else {}
    top, jop = _glm(family, link, rows, **extra)
    assert top._steps == jop._steps, (
        f"the port stopped at {top._steps}, the JAX package at {jop._steps}")
    # gamma/inverse stops after one step in both packages: from beta = 0
    # the inverse link's mean is 1e10 and the first solve moves beta by
    # less than epsilon
    assert (top._steps == 1) if link == "inverse" else (2 <= top._steps < 50)
    tb = tg.GlmModelConverter().load_model(top.get_output_table())
    jb = jg.GlmModelConverter().load_model(jop.get_output_table())
    np.testing.assert_allclose(tb["beta"], jb["beta"], rtol=RTOL,
                               atol=RTOL * np.abs(jb["beta"]).max())
    assert {k: v for k, v in tb.items() if k != "beta"} == \
        {k: v for k, v in jb.items() if k != "beta"}


@pytest.mark.parametrize("family,link", CASES)
def test_predict_and_evaluation_match_the_jax_package(family, link,
                                                      jax_default_1dev):
    rows = family_rows(family, link)
    top, jop = _glm(family, link, rows)
    held = family_rows(family, link, n=100, seed=3)
    pkw = dict(prediction_col="mu", link_pred_result_col="eta")
    outs = []
    for table in (top.get_output_table(), simple_model_table_from_reference(
            jop.get_output_table().to_rows())):
        outs.append(tg.GlmPredictBatchOp(device="cpu", **pkw).link_from(
            TMem(table), TMem(held, SCHEMA)).get_output_table())
    for table in (jop.get_output_table(), JMTable(
            top.get_output_table().to_rows(),
            "model_id LONG, model_info STRING")):
        outs.append(jg.GlmPredictBatchOp(**pkw).link_from(
            JMem(table), JMem(held, SCHEMA)).get_output_table())
    t_own, t_jax, j_own, j_port = outs
    for a, b in ((t_jax, j_own), (t_own, j_port)):
        assert a.col_names == b.col_names
        np.testing.assert_array_equal(np.asarray(a.col("eta")),
                                      np.asarray(b.col("eta")))
        np.testing.assert_allclose(np.asarray(a.col("mu")),
                                   np.asarray(b.col("mu")), rtol=1e-14)
    ev = dict(label_col="y", prediction_col="mu", family=family)
    te = tg.GlmEvaluationBatchOp(**ev).link_from(TMem(t_own)) \
        .get_output_table()
    je = jg.GlmEvaluationBatchOp(**ev).link_from(JMem(_jax_table(t_own))) \
        .get_output_table()
    assert te.to_rows() == je.to_rows()
    dev = json.loads(te.col("summary")[0])["deviance"]
    y = np.asarray(t_own.col("y"))
    mu = np.asarray(t_own.col("mu"))
    assert dev == tg.glm_deviance(y, mu, family) and np.isfinite(dev)


def test_pav_and_isotonic_ops_equal_the_jax_package():
    rng = np.random.RandomState(0)
    n = 500
    x = np.round(rng.rand(n) * 50, 1)                  # ties on purpose
    y = np.log1p(x) + rng.randn(n) * 0.3
    w = rng.rand(n) + 0.2
    for a, b in zip(tg.pav(x, y, w), jg.pav(x, y, w)):
        np.testing.assert_array_equal(a, b)
    rows = [(float(a), float(b), float(c)) for a, b, c in zip(x, y, w)]
    schema = "x DOUBLE, y DOUBLE, w DOUBLE"
    kw = dict(feature_col="x", label_col="y", weight_col="w")
    top = tg.IsotonicRegTrainBatchOp(**kw).link_from(TMem(rows, schema))
    jop = jg.IsotonicRegTrainBatchOp(**kw).link_from(JMem(rows, schema))
    assert top.get_output_table().to_rows() == jop.get_output_table().to_rows()
    held = [(float(v), 0.0, 1.0) for v in np.linspace(-5, 60, 77)]
    tout = tg.IsotonicRegPredictBatchOp(prediction_col="p").link_from(
        top, TMem(held, schema)).get_output_table()
    jout = jg.IsotonicRegPredictBatchOp(prediction_col="p").link_from(
        jop, JMem(held, schema)).get_output_table()
    assert tout.to_rows() == jout.to_rows()
    p = np.asarray(tout.col("p"))
    assert (np.diff(p) >= 0).all()


def aft_rows(n=300, seed=0, censored=0.3):
    """Weibull survival times from a seeded beta and sigma, a censored
    share of rows (their times cut short)."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 3)
    beta = np.asarray([1.0, 0.4, -0.3, 0.2])
    logt = beta[0] + X @ beta[1:] + 0.5 * np.log(rng.exponential(size=n))
    t = np.exp(logt)
    cens = rng.rand(n) < censored
    t = np.where(cens, t * rng.rand(n), t)
    return [(*map(float, x), float(v), float(not c))
            for x, v, c in zip(X, t, cens)]


AFT_SCHEMA = "x0 DOUBLE, x1 DOUBLE, x2 DOUBLE, t DOUBLE, event DOUBLE"


def _aft_data(rows, dtype=np.float64):
    a = np.asarray(rows)
    X = np.concatenate([np.ones((len(a), 1)), a[:, :3]], 1).astype(dtype)
    return {"X": X, "y": np.log(np.maximum(a[:, 3].astype(dtype), 1e-12)),
            "w": np.ones(len(a), dtype), "c": a[:, 4].astype(dtype)}


def test_aft_matches_the_jax_package(jax_default_1dev):
    rows = aft_rows()
    data = _aft_data(rows)
    curves, coefs = {}, {}
    for steps in (10, 5):
        p = dict(method="LBFGS", max_iter=steps, epsilon=0.0)
        tc, tcurve, tn = topt.optimize(tg._AftObjFunc(4), data,
                                       topt.OptimParams(**p),
                                       TEnv(device="cpu"))
        jc, jcurve, jn = jopt.optimize(jg._AftObjFunc(4), data,
                                       jopt.OptimParams(**p))
        assert tn == jn == steps
        curves[steps] = (np.asarray(tcurve), np.asarray(jcurve))
        coefs[steps] = (np.asarray(tc), np.asarray(jc))
    tcurve, jcurve = curves[10]
    assert tcurve[-1] < tcurve[0]
    np.testing.assert_allclose(tcurve, jcurve, rtol=RTOL)
    tc, jc = coefs[5]
    np.testing.assert_allclose(tc, jc, rtol=RTOL, atol=RTOL * np.abs(jc).max())
    # the ops: the port's side output is its optimize run's curve
    kw = dict(feature_cols=["x0", "x1", "x2"], label_col="t",
              censor_col="event", max_iter=10, epsilon=0.0)
    top = tg.AftSurvivalRegTrainBatchOp(device="cpu", dtype=torch.float64,
                                        **kw).link_from(TMem(rows, AFT_SCHEMA))
    jop = jg.AftSurvivalRegTrainBatchOp(**kw).link_from(
        JMem(rows, AFT_SCHEMA))
    np.testing.assert_array_equal(
        np.asarray(top.get_side_output(0).get_output_table().col("loss")),
        tcurve)
    tb = tg.GlmModelConverter().load_model(top.get_output_table())["beta"]
    jb = jg.GlmModelConverter().load_model(jop.get_output_table())["beta"]
    np.testing.assert_allclose(tb, jb, rtol=RTOL,
                               atol=RTOL * np.abs(jb).max())
    held = aft_rows(50, seed=4)
    tout = tg.AftSurvivalRegPredictBatchOp(prediction_col="p").link_from(
        top, TMem(held, AFT_SCHEMA)).get_output_table()
    jout = jg.AftSurvivalRegPredictBatchOp(prediction_col="p").link_from(
        JMem(JMTable(top.get_output_table().to_rows(),
                     "model_id LONG, model_info STRING")),
        JMem(held, AFT_SCHEMA)).get_output_table()
    assert tout.to_rows() == jout.to_rows()


def test_pipeline_stages_fit_and_transform():
    rows = family_rows("poisson", "log")
    kw = dict(feature_cols=FEATS, label_col="y", family="poisson")
    model = GeneralizedLinearRegression(
        device="cpu", dtype=torch.float64, prediction_col="mu", **kw).fit(
        TMem(rows, SCHEMA))
    got = model.transform(TMem(rows, SCHEMA)).get_output_table()
    op = tg.GlmTrainBatchOp(device="cpu", dtype=torch.float64, **kw) \
        .link_from(TMem(rows, SCHEMA))
    want = tg.GlmPredictBatchOp(device="cpu", prediction_col="mu") \
        .link_from(op, TMem(rows, SCHEMA)).get_output_table()
    assert got.to_rows() == want.to_rows()
    iso = IsotonicRegression(feature_col="x0", label_col="y",
                             prediction_col="p").fit(TMem(rows, SCHEMA))
    assert iso.transform(TMem(rows, SCHEMA)).get_output_table().num_rows \
        == len(rows)
    arows = aft_rows()
    aft = AftSurvivalRegression(
        device="cpu", dtype=torch.float64, feature_cols=["x0", "x1", "x2"],
        label_col="t", censor_col="event", max_iter=10,
        prediction_col="p").fit(TMem(arows, AFT_SCHEMA))
    p = np.asarray(aft.transform(TMem(arows, AFT_SCHEMA)).get_output_table()
                   .col("p"))
    assert np.isfinite(p).all() and (p > 0).all()
