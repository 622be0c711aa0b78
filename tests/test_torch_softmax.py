"""Slice 13 of the port: Softmax (multinomial logistic regression) on the
CPU against the JAX package.

The same seeded tables train in both packages in float64 (the JAX side
under x64 on a 1-device session, the port with ``device="cpu"``,
``dtype=torch.float64``), dense ``feature_cols`` and a padded-COO
``vector_col``, k in {3, 5}, 10 supersteps at ``epsilon=0``.
Tolerances:

* the model table's coefficients and the loss curve: rtol 1e-10 (atol
  1e-12); measured at most 4.7e-14 relative;
* predictions from either package's table in either package's predict
  op: labels equal, details within rtol 1e-12 of the table's own
  package;
* ``CompiledPredictor(..., device="cpu", ship_dtype=torch.float64)``:
  labels equal to ``map_table``'s, scores within the rounding band of
  each logit (2 eps sum|terms|: the kernels sum a row left to right,
  ``map_table`` through numpy);
* the objective's pieces (gradient, loss, line losses, Hessian): rtol
  1e-12 (measured at most 5.3e-15), the regularization rtol 1e-15;
  ``optimize`` under LBFGS, OWLQN and NEWTON: rtol 1e-10, as above
  (measured at most 5.0e-14).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alink_tpu.common.mlenv import MLEnvironment as JEnv
from alink_tpu.operator.common.optim import objfunc as jo
from alink_tpu.operator.common.optim import optimizers as jopt
from alink_tpu_torch.common.mlenv import MLEnvironment as TEnv
from alink_tpu_torch.common.mtable import MTable as TMTable
from alink_tpu_torch.common.types import TableSchema as TSchema
from alink_tpu_torch.common.vector import SparseVector as TSparse
from alink_tpu_torch.operator.batch.classification import (
    SoftmaxPredictBatchOp as TPredict, SoftmaxTrainBatchOp as TTrain)
from alink_tpu_torch.operator.batch.source import MemSourceBatchOp as TMem
from alink_tpu_torch.operator.common.linear.base import \
    LinearModelDataConverter as TConverter
from alink_tpu_torch.operator.common.linear.mapper import \
    LinearModelMapper as TMapper
from alink_tpu_torch.operator.common.optim import objfunc as to
from alink_tpu_torch.operator.common.optim import optimizers as topt
from alink_tpu_torch.serving import CompiledPredictor

N, D = 240, 6
EPS = np.finfo(np.float64).eps


@pytest.fixture(scope="module")
def jsid():
    from alink_tpu.common.mlenv import MLEnvironment, MLEnvironmentFactory
    sid = MLEnvironmentFactory.register(
        MLEnvironment(parallelism=1, devices=jax.devices()[:1]))
    yield sid
    MLEnvironmentFactory.remove(sid)


@pytest.fixture(scope="module")
def jenv():
    return JEnv(parallelism=1, devices=jax.devices()[:1])


@pytest.fixture(scope="module")
def tenv():
    return TEnv(device="cpu")


def _tables(layout, k, seed=0):
    """Blobs around k seeded centers, labels ``c0``..; correlated dense
    columns, or padded-COO rows that drop a seeded share of entries."""
    from alink_tpu.common.mtable import MTable as JMTable
    from alink_tpu.common.vector import SparseVector as JSparse
    rng = np.random.RandomState(seed)
    centers = rng.randn(k, D) * 1.2
    yc = rng.randint(0, k, N)
    X = (centers[yc] + rng.randn(N, D)) @ (np.eye(D) + 0.5 * rng.randn(D, D))
    labels = np.asarray([f"c{c}" for c in yc], object)
    out = []
    for MT, SV in ((JMTable, JSparse), (TMTable, TSparse)):
        if layout == "dense":
            data = {f"f{j}": X[:, j] for j in range(D)}
            spec = ", ".join(f"f{j} DOUBLE" for j in range(D))
        else:
            keep = np.random.RandomState(seed + 1).rand(N, D) < 0.7
            col = np.empty(N, object)
            col[:] = [SV(D, np.flatnonzero(keep[i]), X[i, keep[i]])
                      for i in range(N)]
            data, spec = {"vec": col}, "vec VECTOR"
        data["label"] = labels
        out.append(MT(data, spec + ", label STRING"))
    return out


def _params(layout, std, icpt, **more):
    p = dict(label_col="label", max_iter=10, epsilon=0.0, l2=1e-3,
             standardization=std, with_intercept=icpt, **more)
    if layout == "dense":
        p["feature_cols"] = [f"f{j}" for j in range(D)]
    else:
        p["vector_col"] = "vec"
    return p


def _train(layout, k, std, icpt, jsid, **more):
    from alink_tpu.operator.batch.classification.linear import \
        SoftmaxTrainBatchOp as JTrain
    from alink_tpu.operator.batch.source.sources import \
        MemSourceBatchOp as JMem
    jt, tt = _tables(layout, k)
    p = _params(layout, std, icpt, **more)
    jop = JTrain(ml_environment_id=jsid, **p).link_from(
        JMem(jt, ml_environment_id=jsid))
    top = TTrain(device="cpu", dtype=torch.float64, **p).link_from(TMem(tt))
    return jt, tt, jop, top


def _curve(op):
    return np.asarray(op.get_side_output(0).get_output_table().col("loss"))


@pytest.mark.parametrize("std,icpt", [(True, True), (False, False),
                                      (True, False)])
@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_model_table_matches_the_jax_package(layout, k, std, icpt, jsid):
    from alink_tpu.operator.common.linear.base import \
        LinearModelDataConverter as JConverter
    _, _, jop, top = _train(layout, k, std, icpt, jsid)
    jm = JConverter.load_table(jop.get_output_table())
    tm = TConverter.load_table(top.get_output_table())
    for f in ("model_name", "linear_model_type", "has_intercept",
              "vector_col", "feature_names", "vector_size", "label_values",
              "label_type"):
        assert getattr(tm, f) == getattr(jm, f), f
    assert tm.linear_model_type == "Softmax" and len(tm.label_values) == k
    assert tm.coef.shape == jm.coef.shape == ((k - 1) * (D + icpt),)
    jl, tl = _curve(jop), _curve(top)
    assert len(tl) == len(jl) == 10 and tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(tm.coef, jm.coef, rtol=1e-10, atol=1e-12)


def _jax_table(t):
    from alink_tpu.common.mtable import MTable as JMTable
    from alink_tpu.common.types import TableSchema as JSchema
    return JMTable(t.to_rows(), JSchema(list(t.schema.names),
                                        list(t.schema.types)))


def _port_table(t):
    return TMTable(t.to_rows(), TSchema(list(t.schema.names),
                                        list(t.schema.types)))


def _details(table, labels):
    return np.asarray([[json.loads(d)[c] for c in labels]
                       for d in table.col("det")])


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_each_table_scores_in_the_other_package(layout, k, jsid):
    from alink_tpu.operator.batch.classification.linear import \
        SoftmaxPredictBatchOp as JPredict
    from alink_tpu.operator.batch.source.sources import \
        MemSourceBatchOp as JMem
    jt, tt, jop, top = _train(layout, k, True, True, jsid)
    pp = dict(prediction_col="pred", prediction_detail_col="det")
    feats = [c for c in jt.schema.names if c != "label"]
    labels = [f"c{c}" for c in range(k)]

    def jpredict(model):
        return JPredict(ml_environment_id=jsid, **pp).link_from(
            JMem(model, ml_environment_id=jsid),
            JMem(jt.select(feats), ml_environment_id=jsid)).get_output_table()

    def tpredict(model):
        return TPredict(**pp).link_from(
            TMem(model), TMem(tt.select(feats))).get_output_table()

    tmodel, jmodel = top.get_output_table(), jop.get_output_table()
    for own, other in ((tpredict(tmodel), jpredict(_jax_table(tmodel))),
                       (jpredict(jmodel), tpredict(_port_table(jmodel)))):
        assert list(own.col("pred")) == list(other.col("pred"))
        np.testing.assert_allclose(_details(other, labels),
                                   _details(own, labels), rtol=1e-12)
    acc = np.mean(np.asarray(tpredict(tmodel).col("pred"))
                  == np.asarray(tt.col("label")))
    assert acc > 1.5 / k


@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_compiled_predictor_serves_softmax_like_map_table(layout, jsid):
    """The served labels are ``map_table``'s, each logit within its
    rounding band; buckets do not move a row's scores."""
    from alink_tpu_torch.common.params import Params
    jt, tt, _, top = _train(layout, 5, True, True, jsid)
    table = top.get_output_table()
    feats = tt.select([c for c in tt.schema.names if c != "label"])
    params = Params({"prediction_col": "pred", "prediction_detail_col": "det",
                     **({"vector_col": "vec"} if layout == "sparse" else {})})
    mapper = TMapper(table.schema, feats.schema, params)
    mapper.load_model(table)
    pred = CompiledPredictor(mapper, buckets=(1, 16, 64), device="cpu",
                             ship_dtype=torch.float64)
    served, host = pred.predict_table(feats), mapper.map_table(feats)
    assert list(served.col("pred")) == list(host.col("pred"))
    labels = [f"c{c}" for c in range(5)]
    np.testing.assert_allclose(_details(served, labels),
                               _details(host, labels), rtol=1e-12)
    m = TConverter.load_table(table)
    W = m.coef.reshape(4, D + 1)
    X = np.stack([r.to_dense().data if layout == "sparse" else r
                  for r in (feats.col("vec") if layout == "sparse"
                            else np.asarray(feats.to_rows(), float))])
    terms = np.abs(X) @ np.abs(W[:, 1:]).T + np.abs(W[:, 0])
    scores = pred.predict_scores(feats)
    assert scores.shape == (N, 4)
    assert (np.abs(scores - mapper.predict_scores(feats)[:, :4])
            <= 2 * EPS * terms).all()
    np.testing.assert_array_equal(pred.predict_scores(feats.take_rows(
        np.arange(7))), scores[:7])


def test_softmax_pipeline_round_trip(jsid):
    """``Softmax(...).fit(...).transform(...)``: the model table (the
    estimator trains in the train op's default float32) and the labels
    of the train and predict ops, which hold to the JAX package above;
    the model saved and loaded in a ``PipelineModel``."""
    import os
    import tempfile
    from alink_tpu_torch.pipeline import PipelineModel
    from alink_tpu_torch.pipeline.classification import Softmax
    _, tt = _tables("dense", 3)
    p = dict(_params("dense", True, True), prediction_col="pred")
    top = TTrain(device="cpu", **_params("dense", True, True)).link_from(
        TMem(tt))
    model = Softmax(device="cpu", **p).fit(TMem(tt))
    assert model.get_model_data().to_rows() == \
        top.get_output_table().to_rows()
    want = TPredict(prediction_col="pred").link_from(
        top, TMem(tt)).get_output_table()
    out = model.transform(TMem(tt)).get_output_table()
    assert list(out.col("pred")) == list(want.col("pred"))
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "softmax.json")
        PipelineModel(model).save(path)
        back = PipelineModel.load(path).transform(TMem(tt))
    assert list(back.get_output_table().col("pred")) == \
        list(want.col("pred"))


# ---------------------------------------------------------------------------
# the objective and the optimizers at the optimize() level
# ---------------------------------------------------------------------------

def _data(layout, k, seed=3, n=N):
    rng = np.random.RandomState(seed)
    centers = rng.randn(k, D) * 1.5
    yc = rng.randint(0, k, n)
    X = (centers[yc] + rng.randn(n, D)) @ (np.eye(D) + 0.5 * rng.randn(D, D))
    X[:, 0] = 1.0
    data = {"X": X} if layout == "dense" else {
        "idx": np.tile(np.arange(D, dtype=np.int32), (n, 1)), "val": X}
    data.update(y=yc.astype(np.float64), w=np.ones(n))
    return data


@pytest.mark.parametrize("layout", ["dense", "coo"])
def test_objective_pieces(layout):
    k = 4
    data = _data(layout, k)
    rng = np.random.RandomState(5)
    coef, dirn = rng.randn((k - 1) * D) * 0.3, rng.randn((k - 1) * D) * 0.3
    steps = np.asarray([0.0, 1.0, 0.5, 0.25])
    jobj = jo.SoftmaxObjFunc(k, D, l2=1e-3, reg_free_cols=1)
    tobj = to.SoftmaxObjFunc(k, D, l2=1e-3, reg_free_cols=1)
    jd = {kk: jnp.asarray(v) for kk, v in data.items()}
    td = {kk: torch.from_numpy(v) for kk, v in data.items()}
    jg, jl, jw = jobj.calc_grad_shard(jd, jnp.asarray(coef))
    tg, tl, tw = tobj.calc_grad_shard(td, torch.from_numpy(coef))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-12)
    assert float(tw) == float(jw)
    jll = jobj.line_losses_shard(jd, jnp.asarray(coef), jnp.asarray(dirn),
                                 jnp.asarray(steps))
    tll = tobj.line_losses_shard(td, torch.from_numpy(coef),
                                 torch.from_numpy(dirn),
                                 torch.from_numpy(steps))
    np.testing.assert_allclose(tll.numpy(), np.asarray(jll), rtol=1e-12)
    jH = jobj.hessian_shard(jd, jnp.asarray(coef))[0]
    tH = tobj.hessian_shard(td, torch.from_numpy(coef))[0]
    assert tH.shape == ((k - 1) * D, (k - 1) * D)
    np.testing.assert_allclose(tH.numpy(), np.asarray(jH), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(
        tobj.regular_loss(torch.from_numpy(coef)).numpy(),
        np.asarray(jobj.regular_loss(jnp.asarray(coef))), rtol=1e-15)


@pytest.mark.parametrize("method", ["LBFGS", "OWLQN", "NEWTON"])
@pytest.mark.parametrize("layout", ["dense", "coo"])
def test_optimize_matches_ten_supersteps(layout, method, jenv, tenv):
    k = 4
    data = _data(layout, k)
    kw = dict(l2=1e-3, reg_free_cols=1, l1=1e-3 if method == "OWLQN" else 0.0)
    w0 = np.random.RandomState(7).randn((k - 1) * D) * 0.05
    p = dict(method=method, max_iter=10, epsilon=0.0)
    jc, jl, js = jopt.optimize(jo.SoftmaxObjFunc(k, D, **kw), data,
                               jopt.OptimParams(**p), jenv, warm_start=w0)
    tc, tl, ts = topt.optimize(to.SoftmaxObjFunc(k, D, **kw), data,
                               topt.OptimParams(**p), tenv, warm_start=w0)
    assert js == ts == 10 and np.isfinite(tl).all()
    np.testing.assert_allclose(tl, np.asarray(jl), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(tc, np.asarray(jc), rtol=1e-10, atol=1e-12)


def test_softmax_train_op_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TTrain(label_col="label", vector_col="vec")
    assert TTrain(device="cpu", label_col="label").device == \
        torch.device("cpu")
