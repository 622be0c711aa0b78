"""Slice 7 of the port as a whole: ``LogisticRegressionTrainBatchOp`` on
the CPU against the JAX package's, and the model tables across.

The same seeded tables train in both packages: dense ``feature_cols``,
a generic sparse ``vector_col`` and a field-aware-hashed ``vector_col``
(one index per field, which both packages detect and train
field-blocked), each with standardization and the intercept on and off.
The port runs with ``device="cpu"`` and ``dtype=torch.float64``, the
JAX package under x64 on a 1-device session, both for 10 supersteps at
``epsilon=0``. Model tables agree at the tolerances of
``tests/test_torch_optim.py``: rtol 1e-10 (atol 1e-12) for the dense
and padded-COO layouts; for the field-blocked one rtol 1e-6 on the loss
curve and atol 1e-4 max|coef| on the coefficients (its gradient is
float32 in both packages). Ten supersteps stay short of convergence
to the last ulp: the dense columns are correlated for that. On an
uncorrelated dense fixture, which converged by superstep 8, the line
search at superstep 9 chose among ladder losses one ulp apart and the
coefficients parted by 4.6e-9 (ROADMAP Queue C). Each package's table then scores in the
other's predict op: labels equal, probabilities within rtol 1e-12 of
the table's own package.
"""

import json

import jax
import numpy as np
import pytest
import torch

from alink_tpu_torch.common.mtable import MTable as TMTable
from alink_tpu_torch.common.types import TableSchema as TSchema
from alink_tpu_torch.common.vector import SparseVector as TSparse
from alink_tpu_torch.operator.batch.classification import (
    LogisticRegressionPredictBatchOp as TPredict,
    LogisticRegressionTrainBatchOp as TTrain)
from alink_tpu_torch.operator.batch.source import MemSourceBatchOp as TMem
from alink_tpu_torch.operator.common.linear.base import \
    LinearModelDataConverter as TConverter

N, D, F, S = 400, 10, 5, 16
LAYOUTS = ("dense", "sparse", "hashed")


@pytest.fixture(scope="module")
def jsid():
    from alink_tpu.common.mlenv import MLEnvironment, MLEnvironmentFactory
    sid = MLEnvironmentFactory.register(
        MLEnvironment(parallelism=1, devices=jax.devices()[:1]))
    yield sid
    MLEnvironmentFactory.remove(sid)


def _rows(layout, seed=0):
    """Columns, schema string and per-row vectors (as (indices, values))
    of one layout, labels from a seeded true model."""
    rng = np.random.RandomState(seed)
    if layout == "dense":
        Z = rng.randn(N, D) @ (np.eye(D) + 0.8 * rng.randn(D, D))
        X = Z * np.arange(1, D + 1) + np.arange(D)
        margin = Z @ rng.randn(D)
        return {f"f{j}": X[:, j] for j in range(D)}, margin, None
    if layout == "sparse":
        dim = 40
        vecs = []
        margin = np.zeros(N)
        truth = rng.randn(dim)
        for i in range(N):
            k = rng.randint(2, 8)
            ix = np.sort(rng.choice(dim, k, replace=False))
            v = rng.rand(k) * 3
            vecs.append((dim, ix, v))
            margin[i] = v @ truth[ix]
        return {}, margin, vecs
    truth = rng.randn(F * S)
    fb = rng.randint(0, S, (N, F)) + np.arange(F) * S
    vecs = [(F * S, fb[i], np.ones(F)) for i in range(N)]
    return {}, truth[fb].sum(1), vecs


def _tables(layout, seed=0):
    """The same training table in both packages."""
    from alink_tpu.common.mtable import MTable as JMTable
    from alink_tpu.common.vector import SparseVector as JSparse
    cols, margin, vecs = _rows(layout, seed)
    rng = np.random.RandomState(seed + 1)
    y = (rng.rand(N) < 1.0 / (1.0 + np.exp(-margin))).astype(np.int64)
    out = []
    for MT, SV in ((JMTable, JSparse), (TMTable, TSparse)):
        data = dict(cols)
        spec = ", ".join(f"{k} DOUBLE" for k in cols)
        if vecs is not None:
            col = np.empty(N, object)
            col[:] = [SV(d, ix, v) for d, ix, v in vecs]
            data = {"vec": col}
            spec = "vec VECTOR"
        data["label"] = y
        out.append(MT(data, spec + ", label LONG"))
    return out


def _params(layout, std, icpt):
    p = dict(label_col="label", max_iter=10, epsilon=0.0, l2=1e-3,
             standardization=std, with_intercept=icpt)
    if layout == "dense":
        p["feature_cols"] = [f"f{j}" for j in range(D)]
    else:
        p["vector_col"] = "vec"
    return p


def _train(layout, std, icpt, jsid):
    from alink_tpu.operator.batch.classification.linear import \
        LogisticRegressionTrainBatchOp as JTrain
    from alink_tpu.operator.batch.source.sources import \
        MemSourceBatchOp as JMem
    jt, tt = _tables(layout)
    p = _params(layout, std, icpt)
    jop = JTrain(ml_environment_id=jsid, **p).link_from(
        JMem(jt, ml_environment_id=jsid))
    top = TTrain(device="cpu", dtype=torch.float64, **p).link_from(TMem(tt))
    return jt, tt, jop, top


@pytest.mark.parametrize("icpt", [True, False])
@pytest.mark.parametrize("std", [True, False])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_model_table_matches_the_jax_package(layout, std, icpt, jsid):
    from alink_tpu.operator.common.linear.base import \
        LinearModelDataConverter as JConverter
    _, _, jop, top = _train(layout, std, icpt, jsid)
    jm = JConverter.load_table(jop.get_output_table())
    tm = TConverter.load_table(top.get_output_table())
    for f in ("model_name", "linear_model_type", "has_intercept",
              "vector_col", "feature_names", "vector_size", "label_values",
              "label_type"):
        assert getattr(tm, f) == getattr(jm, f), f
    assert tm.coef.shape == jm.coef.shape and tm.coef.dtype == np.float64
    jl = np.asarray(jop.get_side_output(0).get_output_table().col("loss"))
    tl = np.asarray(top.get_side_output(0).get_output_table().col("loss"))
    assert len(tl) == len(jl) == 10 and tl[-1] < tl[0]
    if layout == "hashed":
        np.testing.assert_allclose(tl, jl, rtol=1e-6)
        np.testing.assert_allclose(tm.coef, jm.coef, rtol=0,
                                   atol=1e-4 * np.abs(jm.coef).max())
    else:
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


def _probs(table):
    return np.asarray([json.loads(d)["1"] for d in table.col("det")])


@pytest.mark.parametrize("layout", LAYOUTS)
def test_each_table_scores_in_the_other_package(layout, jsid):
    """The port's model table in the JAX package's predict op, and the
    JAX package's in the port's: the labels and probabilities each
    table's own package gives."""
    from alink_tpu.operator.batch.classification.linear import \
        LogisticRegressionPredictBatchOp as JPredict
    from alink_tpu.operator.batch.source.sources import \
        MemSourceBatchOp as JMem
    jt, tt, jop, top = _train(layout, True, True, jsid)
    pp = dict(prediction_col="pred", prediction_detail_col="det")
    feats = [c for c in jt.schema.names if c != "label"]

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
        np.testing.assert_allclose(_probs(other), _probs(own), rtol=1e-12)


def test_train_op_defaults_to_the_card_and_checks_its_dtype(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TTrain(label_col="label", vector_col="vec")
    with pytest.raises(ValueError, match="dtype"):
        TTrain(device="cpu", dtype=torch.float16)
    op = TTrain(device="cpu", label_col="label")
    assert op.dtype == torch.float32 and op.device == torch.device("cpu")


def test_float32_training_runs_on_the_cpu():
    """The default ship dtype is float32: the model trains and its loss
    falls."""
    _, tt = _tables("sparse")
    op = TTrain(device="cpu", **_params("sparse", True, True)).link_from(
        TMem(tt))
    loss = np.asarray(op.get_side_output(0).get_output_table().col("loss"))
    assert np.isfinite(loss).all() and loss[-1] < loss[0]
    assert np.isfinite(TConverter.load_table(op.get_output_table()).coef).all()
