"""Slice 24 of the port: the feature ops on the CPU against the JAX
package.

Tolerances, each stated where it is checked:

* OneHot, QuantileDiscretizer, Bucketizer, Binarizer, ChiSqSelector and
  VectorChiSqSelector: exact (equal model tables, equal output cells).
  OneHot's mapper formats each distinct value once; its indices equal
  the JAX package's per-cell ``str(v)`` loop on LONG, DOUBLE ("3" and
  "3.0"), FLOAT (float32's shortest repr), string, ``None``, NaN and
  -0.0 cells, with vocabularies sorted as strings ("10" < "2") and the
  unseen slot. QuantileDiscretizer is exact on both sides of the
  2,000,000-cell cutover (host ``np.quantile`` below it, the device
  histogram of ``distributed_quantiles`` at it).
* PCA: rtol 1e-12 (the same host SVD in both packages).
* DCT forward and inverse: within 1e-12 of each row's largest |y| (the
  port's ``torch.fft`` against ``jnp.fft``), and the round trip within
  the same bound.
* A JAX-saved ``PipelineModel`` of QuantileDiscretizer -> OneHotEncoder
  -> LogisticRegression loads through ``pipeline_model_from_reference``
  and transforms the same rows to equal labels, details within rtol
  1e-12; the port's own fit of that pipeline (float64) gives equal
  discretizer and one-hot tables and coefficients within rtol 1e-10.

The JAX side runs under x64 on a 1-device default environment, the port
with ``device="cpu"``.
"""

import json

import jax
import numpy as np
import pytest
import torch

from alink_tpu.common.mlenv import MLEnvironment as JEnv
from alink_tpu.common.mlenv import MLEnvironmentFactory as JFactory
from alink_tpu.common.mtable import MTable as JMTable
from alink_tpu.common.vector import DenseVector as JDense
from alink_tpu.operator.batch.feature import feature_ops as jfo
from alink_tpu.operator.batch.source import MemSourceBatchOp as JMem
from alink_tpu_torch.common.mtable import MTable as TMTable
from alink_tpu_torch.common.vector import DenseVector as TDense
from alink_tpu_torch.model.interop import (pipeline_model_from_reference,
                                           simple_model_table_from_reference)
from alink_tpu_torch.operator.batch.feature import feature_ops as tfo
from alink_tpu_torch.operator.batch.source import MemSourceBatchOp as TMem

DCT_BOUND = 1e-12


@pytest.fixture(autouse=True)
def jax_default_1dev():
    prev = JFactory.get_default()
    JFactory.set_default(JEnv(parallelism=1, devices=jax.devices()[:1]))
    yield
    JFactory.set_default(prev)


def _cells(t):
    return repr(t.to_rows())


def _same_tables(t, j):
    assert t.col_names == j.col_names
    assert t.schema.types == j.schema.types
    assert _cells(t) == _cells(j)


# -- OneHot -------------------------------------------------------------------

def _onehot_columns(n=300, seed=0):
    rng = np.random.RandomState(seed)
    code = rng.randint(0, 12, n)
    dbl = code.astype(np.float64)
    dbl[:5] = [np.nan, -0.0, 0.0, 1.5, np.nan]
    f32 = (rng.randint(0, 6, n) * 0.1).astype(np.float32)
    obj = np.asarray([None if k % 7 == 0 else f"t{k % 4}" for k in code],
                     object)
    mixed = np.asarray([None if k == 3 else (float(k) if k % 2 else int(k))
                        for k in code], object)
    s = np.asarray(["b", "a", "10", "2"])[code % 4]
    return {"code": code.astype(np.int64), "dbl": dbl, "f32": f32,
            "obj": obj, "mixed": mixed, "s": s}


ONEHOT_SCHEMA = ("code LONG, dbl DOUBLE, f32 FLOAT, obj STRING, mixed ANY, "
                 "s STRING")


def _onehot_tables(cols):
    return (TMTable(dict(cols), ONEHOT_SCHEMA),
            JMTable(dict(cols), ONEHOT_SCHEMA))


@pytest.mark.parametrize("col", ["code", "dbl", "f32", "obj", "mixed", "s"])
def test_distinct_strs_equal_str_of_each_cell(col):
    a = _onehot_columns()[col]
    inv, strs = tfo._distinct_strs(a)
    assert [strs[k] for k in inv] == [None if v is None else str(v)
                                      for v in a]


def test_onehot_train_and_predict_equal_the_jax_package():
    cols = list(_onehot_columns())
    t_tab, j_tab = _onehot_tables(_onehot_columns())
    top = tfo.OneHotTrainBatchOp(selected_cols=cols).link_from(TMem(t_tab))
    jop = jfo.OneHotTrainBatchOp(selected_cols=cols).link_from(JMem(j_tab))
    assert top.get_output_table().to_rows() == jop.get_output_table().to_rows()
    vocab = json.loads(top.get_output_table().to_rows()[-1][1])
    assert vocab["s"] == ["10", "2", "a", "b"]
    assert "3" in vocab["code"] and "3.0" in vocab["dbl"]
    assert "-0.0" in vocab["dbl"] and "0.0" in vocab["dbl"]
    # held rows with unseen values
    ht, hj = _onehot_tables(_onehot_columns(200, seed=5))
    kw = dict(output_col="oh", reserved_cols=["code"])
    tout = tfo.OneHotPredictBatchOp(**kw).link_from(top, TMem(ht))
    jout = jfo.OneHotPredictBatchOp(**kw).link_from(jop, JMem(hj))
    _same_tables(tout.get_output_table(), jout.get_output_table())
    # each package's table in the other
    into = simple_model_table_from_reference(jop.get_output_table().to_rows())
    again = tfo.OneHotPredictBatchOp(**kw).link_from(TMem(into), TMem(ht))
    _same_tables(again.get_output_table(), jout.get_output_table())


def test_onehot_mapper_equals_the_cell_loop():
    """The JAX package's per-cell loop (its ``map_table``) on the port's
    model: equal vectors, float32 column included."""
    cols = list(_onehot_columns())
    t_tab, j_tab = _onehot_tables(_onehot_columns(400, seed=3))
    model = tfo.OneHotTrainBatchOp(selected_cols=cols[:3]).link_from(
        TMem(_onehot_tables(_onehot_columns())[0])).get_output_table()
    jm = jfo.OneHotModelMapper(None, j_tab.schema)
    jm.load_model(JMTable(model.to_rows(), "model_id LONG, model_info STRING"))
    tm = tfo.OneHotModelMapper(None, t_tab.schema)
    tm.load_model(model)
    assert _cells(tm.map_table(t_tab)) == _cells(jm.map_table(j_tab))
    assert tm.get_output_schema().names == t_tab.col_names + ["one_hot"]


# -- QuantileDiscretizer, Bucketizer, Binarizer -------------------------------

def _num_rows(n, seed=0, cols=3):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, cols) * [1.0, 10.0, 0.1][:cols] + [0, 5, -1][:cols]
    X[rng.rand(n) < 0.01, 0] = np.nan
    X[:, -1] = np.round(X[:, -1], 1)                 # ties
    return X


def _num_tables(X):
    names = [f"x{j}" for j in range(X.shape[1])]
    schema = ", ".join(f"{c} DOUBLE" for c in names)
    cols = {c: X[:, j] for j, c in enumerate(names)}
    return names, TMTable(dict(cols), schema), JMTable(dict(cols), schema)


@pytest.mark.parametrize("n,buckets", [(500, 4), (3000, 20),
                                       (700_000, 20)])
def test_quantile_discretizer_equals_the_jax_package(n, buckets):
    """Exact on both sides of the cutover: 500 x 3 and 3000 x 3 cells on
    the host, 700,000 x 3 (2.1 M cells) through the device histogram."""
    from alink_tpu_torch.operator.common.dataproc.quantile import \
        DEVICE_BINNING_MIN_CELLS
    X = _num_rows(n, seed=n)
    names, tt, jt = _num_tables(X)
    assert (n * 3 >= DEVICE_BINNING_MIN_CELLS) == (n == 700_000)
    top = tfo.QuantileDiscretizerTrainBatchOp(
        selected_cols=names, num_buckets=buckets, device="cpu").link_from(
        TMem(tt))
    jop = jfo.QuantileDiscretizerTrainBatchOp(
        selected_cols=names, num_buckets=buckets).link_from(JMem(jt))
    assert top.get_output_table().to_rows() == jop.get_output_table().to_rows()
    held = _num_rows(300, seed=1)
    _, ht, hj = _num_tables(held)
    tout = tfo.QuantileDiscretizerPredictBatchOp().link_from(top, TMem(ht))
    jout = jfo.QuantileDiscretizerPredictBatchOp().link_from(jop, JMem(hj))
    _same_tables(tout.get_output_table(), jout.get_output_table())
    ids = np.asarray(tout.get_output_table().col("x1"))
    assert ids.min() >= 0 and ids.max() <= buckets - 1


def test_bucketizer_and_binarizer_equal_the_jax_package():
    names, tt, jt = _num_tables(_num_rows(400))
    kw = dict(selected_cols=names[:2], cuts_array=[[-1.0, 0.0, 1.0], [5.0]],
              output_cols=["b0", "b1"])
    _same_tables(tfo.BucketizerBatchOp(**kw).link_from(TMem(tt))
                 .get_output_table(),
                 jfo.BucketizerBatchOp(**kw).link_from(JMem(jt))
                 .get_output_table())
    for kw in (dict(selected_col="x1", threshold=5.0),
               dict(selected_col="x0", output_col="bin")):
        _same_tables(tfo.BinarizerBatchOp(**kw).link_from(TMem(tt))
                     .get_output_table(),
                     jfo.BinarizerBatchOp(**kw).link_from(JMem(jt))
                     .get_output_table())


# -- ChiSqSelector ------------------------------------------------------------

def _cat_rows(n=300, seed=0):
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 2, n)
    a = np.where(rng.rand(n) < 0.8, y, 1 - y)
    b = rng.randint(0, 3, n)
    c = (y + (rng.rand(n) < 0.4)) % 2
    vec = [f"{float(u)} {float(v)} {float(w)}" for u, v, w in zip(a, b, c)]
    return [(int(u), int(v), int(w), s, str(k))
            for u, v, w, s, k in zip(a, b, c, vec, y)]


CAT_SCHEMA = "a LONG, b LONG, c LONG, vec STRING, label STRING"


@pytest.mark.parametrize("top", [1, 2, 3])
def test_chisq_selectors_equal_the_jax_package(top):
    rows = _cat_rows()
    kw = dict(selected_cols=["a", "b", "c"], label_col="label",
              num_top_features=top)
    t = tfo.ChiSqSelectorBatchOp(**kw).link_from(TMem(rows, CAT_SCHEMA))
    j = jfo.ChiSqSelectorBatchOp(**kw).link_from(JMem(rows, CAT_SCHEMA))
    _same_tables(t.get_output_table(), j.get_output_table())
    _same_tables(t.get_side_output(0).get_output_table(),
                 j.get_side_output(0).get_output_table())
    kw = dict(vector_col="vec", label_col="label", num_top_features=top)
    t = tfo.VectorChiSqSelectorBatchOp(**kw).link_from(TMem(rows, CAT_SCHEMA))
    j = jfo.VectorChiSqSelectorBatchOp(**kw).link_from(JMem(rows, CAT_SCHEMA))
    assert t._chosen == j._chosen and len(t._chosen) == top
    _same_tables(t.get_output_table(), j.get_output_table())
    _same_tables(t.get_side_output(0).get_output_table(),
                 j.get_side_output(0).get_output_table())


# -- PCA ----------------------------------------------------------------------

@pytest.mark.parametrize("calc", ["CORR", "COV"])
def test_pca_equals_the_jax_package(calc):
    """rtol 1e-12 on the model and the projections."""
    rng = np.random.RandomState(0)
    base = rng.randn(300, 3)
    X = np.hstack([base, base @ [[1.0], [2.0], [0.5]] + 0.01 * rng.randn(300, 1),
                   5.0 + 0 * base[:, :1]])           # a constant column
    names = ["x", "y", "z", "w", "k"]
    schema = ", ".join(f"{c} DOUBLE" for c in names)
    rows = [tuple(map(float, r)) for r in X]
    kw = dict(selected_cols=names, k=3, calculation_type=calc)
    top = tfo.PcaTrainBatchOp(**kw).link_from(TMem(rows, schema))
    jop = jfo.PcaTrainBatchOp(**kw).link_from(JMem(rows, schema))
    tm = tfo.PcaModelConverter().load_model(top.get_output_table())
    jm = jfo.PcaModelConverter().load_model(jop.get_output_table())
    for a, b in zip(tm, jm):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12 * np.abs(b).max())
    pk = dict(selected_cols=names, prediction_col="p", reserved_cols=["x"])
    tp = tfo.PcaPredictBatchOp(**pk).link_from(top, TMem(rows, schema))
    jp = jfo.PcaPredictBatchOp(**pk).link_from(jop, JMem(rows, schema))
    Zt = np.stack([v.data for v in tp.get_output_table().col("p")])
    Zj = np.stack([v.data for v in jp.get_output_table().col("p")])
    np.testing.assert_allclose(Zt, Zj, rtol=1e-12, atol=1e-12 * np.abs(Zj).max())
    assert tp.get_output_table().col_names == ["x", "p"]


# -- DCT ----------------------------------------------------------------------

def _dct_rows(n, m, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, m) * rng.choice([1e-3, 1.0, 1e3], size=(n, 1))
    return X


def _row_bound_ok(got, want):
    scale = np.abs(want).max(1, keepdims=True)
    return float((np.abs(got - want) / np.where(scale > 0, scale, 1.0)).max())


@pytest.mark.parametrize("m", [1, 2, 7, 64, 255])
def test_dct_equals_the_jax_package_and_round_trips(m):
    """Within 1e-12 of each row's largest |y|, forward and inverse; the
    port's round trip within the same bound of the input."""
    X = _dct_rows(40, m, seed=m)
    trows = [(TDense(x),) for x in X]
    jrows = [(JDense(x),) for x in X]
    tf = tfo.DCTBatchOp(selected_col="v", output_col="f", device="cpu") \
        .link_from(TMem(trows, ["v"]))
    jf = jfo.DCTBatchOp(selected_col="v", output_col="f").link_from(
        JMem(jrows, ["v"]))
    Yt = np.stack([v.data for v in tf.get_output_table().col("f")])
    Yj = np.stack([v.data for v in jf.get_output_table().col("f")])
    assert _row_bound_ok(Yt, Yj) <= DCT_BOUND
    ti = tfo.DCTBatchOp(selected_col="f", output_col="b", inverse=True,
                        device="cpu").link_from(tf)
    ji = jfo.DCTBatchOp(selected_col="f", output_col="b", inverse=True) \
        .link_from(jf)
    Bt = np.stack([v.data for v in ti.get_output_table().col("b")])
    Bj = np.stack([v.data for v in ji.get_output_table().col("b")])
    assert _row_bound_ok(Bt, Bj) <= DCT_BOUND
    assert _row_bound_ok(Bt, X) <= DCT_BOUND
    # the inverse alone, on the JAX package's forward output
    Ii = tfo.dct2_ortho(torch.from_numpy(Yj), inverse=True).numpy()
    assert _row_bound_ok(Ii, X) <= DCT_BOUND


def test_dct_stage_takes_the_pipelines_device(monkeypatch):
    """Without CUDA a ``DCT`` stage runs in a ``Pipeline(device="cpu")``
    and its stream transform, and raises given no device at all."""
    import alink_tpu_torch.pipeline as P
    from alink_tpu_torch.operator.stream.source import \
        MemSourceStreamOp as TMemS
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X = _dct_rows(6, 8)
    rows = [(TDense(x),) for x in X]
    model = P.Pipeline(P.DCT(selected_col="v", output_col="f"),
                       device="cpu").fit(TMem(rows, ["v"]))
    Y = np.stack([v.data for v in model.transform(TMem(rows, ["v"]))
                  .get_output_table().col("f")])
    np.testing.assert_array_equal(
        Y, tfo.dct2_ortho(torch.from_numpy(X)).numpy())
    got = [mt for mt in model.transform_stream(TMemS(
        rows, ["v"], batch_size=4)).micro_batches()]
    assert sum(mt.num_rows for mt in got) == 6
    with pytest.raises(RuntimeError, match="CUDA"):
        P.Pipeline(P.DCT(selected_col="v", output_col="f")).fit(
            TMem(rows, ["v"]))


def test_dct_of_an_empty_table():
    out = tfo.DCTBatchOp(selected_col="v", device="cpu").link_from(
        TMem(TMTable({"v": np.empty(0, object)}, "v DENSE_VECTOR")))
    assert out.get_output_table().num_rows == 0


# -- the pipeline across ------------------------------------------------------

PIPE_SCHEMA = ("age DOUBLE, hours DOUBLE, edu LONG, job STRING, "
               "label STRING")


def _pipe_rows(n=400, seed=0):
    rng = np.random.RandomState(seed)
    age = rng.randint(17, 90, n).astype(float)
    hours = np.round(rng.gamma(4.0, 10.0, n), 1)
    edu = rng.randint(1, 16, n)
    job = np.asarray(["a", "b", "c", "d"])[rng.randint(0, 4, n)]
    z = 0.04 * (age - 40) + 0.05 * (hours - 40) + 0.2 * (edu - 8) + \
        (job == "c") - 0.5 + rng.randn(n)
    label = np.where(z > 0, ">50K", "<=50K")
    return [(float(a), float(h), int(e), str(j), str(y))
            for a, h, e, j, y in zip(age, hours, edu, job, label)]


def _pipelines(P, C, F, device=None):
    dev = {} if device is None else {"device": device}
    stages = (F.QuantileDiscretizer(selected_cols=["age", "hours"],
                                    num_buckets=5, **dev),
              F.OneHotEncoder(selected_cols=["age", "hours", "edu", "job"],
                              output_col="oh", **dev),
              C.LogisticRegression(vector_col="oh", label_col="label",
                                   prediction_col="p",
                                   prediction_detail_col="d", max_iter=20,
                                   **dev))
    if device is not None:
        stages[2].dtype = torch.float64
    return P.Pipeline(*stages)


def test_jax_saved_pipeline_loads_and_transforms_equally(tmp_path):
    import alink_tpu.pipeline as JP
    import alink_tpu.pipeline.classification as JC
    import alink_tpu.pipeline.feature as JF
    train, held = _pipe_rows(), _pipe_rows(200, seed=1)
    jmodel = _pipelines(JP, JC, JF).fit(JMem(train, PIPE_SCHEMA))
    path = str(tmp_path / "jax_pipeline.json")
    jmodel.save(path)
    names = [s["className"] for s in json.load(open(path))["stages"]]
    assert names == ["alink_tpu.pipeline.feature.QuantileDiscretizerModel",
                     "alink_tpu.pipeline.feature.OneHotEncoderModel",
                     "alink_tpu.pipeline.classification."
                     "LogisticRegressionModel"]
    tmodel = pipeline_model_from_reference(path)
    got = tmodel.transform(TMem(held, PIPE_SCHEMA)).get_output_table()
    want = jmodel.transform(JMem(held, PIPE_SCHEMA)).get_output_table()
    assert got.col_names == want.col_names
    assert list(got.col("p")) == list(want.col("p"))
    assert _cells(got.select(["age", "hours", "oh"])) == \
        _cells(want.select(["age", "hours", "oh"]))
    for u, v in zip(got.col("d"), want.col("d")):
        du, dv = json.loads(u), json.loads(v)
        np.testing.assert_allclose([du[k] for k in dv], [dv[k] for k in dv],
                                   rtol=1e-12)


def test_port_fit_of_the_pipeline_equals_the_jax_fit():
    import alink_tpu.pipeline as JP
    import alink_tpu.pipeline.classification as JC
    import alink_tpu.pipeline.feature as JF
    import alink_tpu_torch.pipeline as TP
    import alink_tpu_torch.pipeline.classification as TC
    import alink_tpu_torch.pipeline.feature as TF
    train = _pipe_rows()
    tmodel = _pipelines(TP, TC, TF, device="cpu").fit(TMem(train, PIPE_SCHEMA))
    jmodel = _pipelines(JP, JC, JF).fit(JMem(train, PIPE_SCHEMA))
    for k in (0, 1):
        assert tmodel.transformers[k].get_model_data().to_rows() == \
            jmodel.transformers[k].get_model_data().to_rows()
    from alink_tpu.operator.common.linear.base import \
        LinearModelDataConverter as JConv
    from alink_tpu_torch.operator.common.linear.base import \
        LinearModelDataConverter as TConv
    tc = TConv().load_model(tmodel.transformers[2].get_model_data()).coef
    jc = JConv().load_model(jmodel.transformers[2].get_model_data()).coef
    np.testing.assert_allclose(tc, jc, rtol=1e-10, atol=1e-10 * np.abs(jc).max())
