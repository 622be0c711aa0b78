"""Slice 15 of the port: the multiclass, regression and cluster evaluation
on the CPU against the JAX package.

The metrics are host numpy copied from the JAX package, so every check
is exact: the metric functions' JSON, the batch ops' one-row tables and
the stream ops' window and cumulative rows equal the JAX package's
string for string, on the same seeded rows.
"""

import json

import numpy as np
import pytest

from alink_tpu.operator.batch.evaluation import eval_ops as jev
from alink_tpu.operator.batch.source import MemSourceBatchOp as JMem
from alink_tpu.operator.common.evaluation import metrics as jm
from alink_tpu.operator.stream import evaluation as jsev
from alink_tpu.operator.stream.source import MemSourceStreamOp as JMemStream
from alink_tpu_torch.operator.batch.evaluation import (EvalClusterBatchOp,
                                                       EvalMultiClassBatchOp,
                                                       EvalRegressionBatchOp)
from alink_tpu_torch.operator.batch.source import MemSourceBatchOp as TMem
from alink_tpu_torch.operator.common.evaluation import metrics as tm
from alink_tpu_torch.operator.stream import (EvalMultiClassStreamOp,
                                             EvalRegressionStreamOp)
from alink_tpu_torch.operator.stream.source import \
    MemSourceStreamOp as TMemStream


def _multiclass_rows(n=600, seed=0):
    rng = np.random.RandomState(seed)
    labels = rng.choice(["a", "b", "c", "d"], n)
    flip = rng.rand(n) < 0.3
    preds = np.where(flip, rng.choice(["a", "b", "c", "e"], n), labels)
    rows = []
    for l, p in zip(labels, preds):
        probs = rng.dirichlet(np.ones(4))
        rows.append((str(l), str(p), json.dumps(
            dict(zip(["a", "b", "c", "d"], probs.round(6).tolist())))))
    return rows, "label STRING, pred STRING, detail STRING"


def _regression_rows(n=500, seed=1):
    rng = np.random.RandomState(seed)
    y = rng.randn(n) * 3 + 1
    p = y + rng.randn(n) * 0.5
    return ([(float(a), float(b)) for a, b in zip(y, p)],
            "label DOUBLE, pred DOUBLE")


def _cluster_rows(n=300, seed=2, sparse=False):
    rng = np.random.RandomState(seed)
    centers = np.asarray([[0.0, 0.0, 0.0], [5.0, 5.0, 0.0], [0.0, 5.0, 5.0]])
    lab = rng.randint(0, 3, n)
    X = centers[lab] + rng.randn(n, 3)
    cid = np.where(rng.rand(n) < 0.1, (lab + 1) % 3, lab)
    if sparse:
        vec = ["$3$" + " ".join(f"{j}:{x[j]!r}" for j in range(3) if j != 1)
               for x in X]
    else:
        vec = [" ".join(repr(float(v)) for v in x) for x in X]
    return ([(v, int(c), f"t{l}") for v, c, l in zip(vec, cid, lab)],
            "vec STRING, cid LONG, truth STRING")


@pytest.mark.parametrize("with_details", [False, True])
def test_multiclass_metrics_json(with_details):
    rows, _ = _multiclass_rows()
    labels, preds, details = map(list, zip(*rows))
    d = details if with_details else None
    got = tm.multiclass_metrics(labels, preds, d)
    want = jm.multiclass_metrics(labels, preds, d)
    assert type(got).__name__ == "MultiClassMetrics"
    assert got.to_json() == want.to_json()
    assert ("LogLoss" in got.to_dict()) == with_details
    assert got.get_accuracy() == want.get_accuracy()


def test_regression_metrics_json():
    rows, _ = _regression_rows()
    y, p = (np.asarray(c) for c in zip(*rows))
    got = tm.regression_metrics(y, p)
    assert got.to_json() == jm.regression_metrics(y, p).to_json()
    assert got.get_rmse() == pytest.approx(np.sqrt(((p - y) ** 2).mean()))


@pytest.mark.parametrize("labelled", [False, True])
def test_cluster_metrics_json(labelled):
    rng = np.random.RandomState(4)
    X = np.concatenate([rng.randn(80, 2) + c for c in ((0, 0), (6, 0),
                                                        (0, 6))])
    a = np.repeat([0, 1, 2], 80)
    a[::17] = (a[::17] + 1) % 3
    labels = [f"t{v}" for v in np.repeat([0, 1, 2], 80)] if labelled else None
    got = tm.cluster_metrics(X, a, labels)
    assert got.to_json() == jm.cluster_metrics(X, a, labels).to_json()
    assert ("NMI" in got.to_dict()) == labelled
    # no features: the counts alone
    assert tm.cluster_metrics(None, a).to_json() == \
        jm.cluster_metrics(None, a).to_json()


def _table_json(op):
    return op.get_output_table().col("Data")[0]


@pytest.mark.parametrize("detail", [None, "detail"])
def test_eval_multiclass_batch_op(detail):
    rows, schema = _multiclass_rows()
    kw = dict(label_col="label", prediction_col="pred")
    if detail:
        kw["prediction_detail_col"] = detail
    got = EvalMultiClassBatchOp(**kw).link_from(TMem(rows, schema))
    want = jev.EvalMultiClassBatchOp(**kw).link_from(JMem(rows, schema))
    assert _table_json(got) == _table_json(want)
    assert got.collect_metrics().to_json() == _table_json(got)


def test_eval_regression_batch_op():
    rows, schema = _regression_rows()
    kw = dict(label_col="label", prediction_col="pred")
    got = EvalRegressionBatchOp(**kw).link_from(TMem(rows, schema))
    want = jev.EvalRegressionBatchOp(**kw).link_from(JMem(rows, schema))
    assert _table_json(got) == _table_json(want)
    assert got.collect_metrics().get("Count") == len(rows)


@pytest.mark.parametrize("sparse,label_col", [(False, None),
                                              (False, "truth"),
                                              (True, "truth")])
def test_eval_cluster_batch_op(sparse, label_col):
    rows, schema = _cluster_rows(sparse=sparse)
    kw = dict(vector_col="vec", prediction_col="cid")
    if label_col:
        kw["label_col"] = label_col
    got = EvalClusterBatchOp(**kw).link_from(TMem(rows, schema))
    want = jev.EvalClusterBatchOp(**kw).link_from(JMem(rows, schema))
    assert _table_json(got) == _table_json(want)
    m = got.collect_metrics().to_dict()
    assert m["K"] == 3 and "SilhouetteCoefficient" in m


def test_collect_metrics_before_link_raises():
    for op in (EvalMultiClassBatchOp(label_col="l", prediction_col="p"),
               EvalRegressionBatchOp(label_col="l", prediction_col="p"),
               EvalClusterBatchOp(prediction_col="p")):
        with pytest.raises(RuntimeError, match="link"):
            op.collect_metrics()


@pytest.mark.parametrize("kind", ["multiclass", "regression"])
def test_eval_stream_ops(kind):
    if kind == "multiclass":
        rows, schema = _multiclass_rows(n=700)
        tcls, jcls = EvalMultiClassStreamOp, jsev.EvalMultiClassStreamOp
    else:
        rows, schema = _regression_rows(n=700)
        tcls, jcls = EvalRegressionStreamOp, jsev.EvalRegressionStreamOp
    kw = dict(label_col="label", prediction_col="pred", time_interval=3.0)
    got = list(tcls(**kw).link_from(TMemStream(
        rows, schema, batch_size=64)).timed_batches())
    want = list(jcls(**kw).link_from(JMemStream(
        rows, schema, batch_size=64)).timed_batches())
    assert len(got) == len(want) == 4
    for (tt, mt), (tj, mj) in zip(got, want):
        assert tt == tj and mt.to_rows() == mj.to_rows()
    # the last "all" row is the batch op's metrics over every row
    batch = (EvalMultiClassBatchOp if kind == "multiclass"
             else EvalRegressionBatchOp)(
        label_col="label", prediction_col="pred").link_from(
        TMem(rows, schema))
    assert got[-1][1].to_rows()[-1] == ("all", _table_json(batch))
