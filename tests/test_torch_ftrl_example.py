"""Slice 9 of the port as a whole: the FTRLExample loop of
``examples/ftrl_example.py`` through ``alink_tpu_torch``, held against the
JAX package's run of the same calls on the CPU.

The twin below makes the example's calls at its size and settings
(1,500 batch rows, 4,000 training and 2,000 evaluation stream rows in
250-row micro-batches, 512 hashed features, LR ``max_iter=15``, FTRL
alpha 0.1, beta 1.0, l1 = l2 = 1e-4, a snapshot every second, 2-second
eval windows) with ``device="cpu"`` and float64 (``dtype`` of the LR,
``ship_dtype`` of FTRL), the JAX package under x64 on a 1-device
environment. Held:

* the fitted feature pipeline's output: bitwise equal;
* the warm-start LR coefficients: rtol 1e-10 (the padded-COO gate of
  ``tests/test_torch_optim.py``);
* every FTRL snapshot, both started from the JAX package's warm start
  carried across with ``model_table_from_reference``: rtol 1e-10;
* the hot-reloaded predictions: equal labels, details within rtol
  1e-10;
* every eval row: equal counts, AUC within 1e-9.

And the pipeline file both ways: a pipeline the JAX package saved loads
through ``pipeline_model_from_reference`` and transforms bitwise like
the JAX model, batch and stream; one the port saved loads in the port
and transforms the same.
"""

import importlib.util
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from alink_tpu_torch.model.interop import (model_table_from_reference,
                                           pipeline_model_from_reference)
from alink_tpu_torch.operator.base import StreamOperator as TStream
from alink_tpu_torch.operator.batch.classification.linear import \
    LogisticRegressionTrainBatchOp as TLR
from alink_tpu_torch.operator.batch.source import MemSourceBatchOp as TMemB
from alink_tpu_torch.operator.common.linear.base import \
    LinearModelDataConverter as TConv
from alink_tpu_torch.operator.stream.evaluation import \
    EvalBinaryClassStreamOp as TEval
from alink_tpu_torch.operator.stream.onlinelearning.ftrl import (
    FtrlPredictStreamOp as TPredict, FtrlTrainStreamOp as TTrain)
from alink_tpu_torch.operator.stream.sink import CollectSinkStreamOp as TSink
from alink_tpu_torch.operator.stream.source import MemSourceStreamOp as TMemS
from alink_tpu_torch.pipeline import Pipeline as TPipeline
from alink_tpu_torch.pipeline import PipelineModel as TPipelineModel
from alink_tpu_torch.pipeline.feature import (FeatureHasher as THasher,
                                              StandardScaler as TScaler)

ROOT = Path(__file__).resolve().parents[1]
FTRL_KW = dict(vector_col="vec", label_col="click", alpha=0.1, beta=1.0,
               l1=1e-4, l2=1e-4, time_interval=1.0)


def _example():
    """``examples/ftrl_example.py`` as a module (its data generator)."""
    spec = importlib.util.spec_from_file_location(
        "_ftrl_example_twin", ROOT / "examples" / "ftrl_example.py",
        submodule_search_locations=None)
    import sys
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(str(ROOT / "examples"))
    return mod


def _stages(pkg):
    if pkg == "torch":
        return TPipeline, TScaler, THasher
    from alink_tpu.pipeline import Pipeline
    from alink_tpu.pipeline.feature import FeatureHasher, StandardScaler
    return Pipeline, StandardScaler, FeatureHasher


def _feature_pipeline(pkg, env):
    Pipeline, StandardScaler, FeatureHasher = _stages(pkg)
    return Pipeline(
        StandardScaler(selected_cols=["c1", "c2"], **env),
        FeatureHasher(selected_cols=["site", "device", "c1", "c2"],
                      categorical_cols=["site", "device"], output_col="vec",
                      num_features=512, **env))


@pytest.fixture(scope="module")
def loops():
    """The example's calls through both packages. The port's FTRL and
    predict legs start from the JAX package's warm-start table."""
    from alink_tpu.common.mlenv import MLEnvironment, MLEnvironmentFactory
    from alink_tpu.operator.batch.classification.linear import \
        LogisticRegressionTrainBatchOp
    from alink_tpu.operator.batch.source import MemSourceBatchOp
    from alink_tpu.operator.stream.evaluation import EvalBinaryClassStreamOp
    from alink_tpu.operator.stream.onlinelearning.ftrl import (
        FtrlPredictStreamOp, FtrlTrainStreamOp)
    from alink_tpu.operator.stream.source.sources import MemSourceStreamOp
    ex = _example()
    sid = MLEnvironmentFactory.register(
        MLEnvironment(parallelism=1, devices=jax.devices()[:1]))
    env = {"ml_environment_id": sid}
    out = {"ex": ex, "env": env}
    # the JAX package
    batch = MemSourceBatchOp(ex.ctr_rows(1500, 1), ex.SCHEMA, **env)
    jfm = _feature_pipeline("jax", env).fit(batch)
    jfeat = jfm.transform(batch)
    jlr = LogisticRegressionTrainBatchOp(
        vector_col="vec", label_col="click", max_iter=15, **env).link_from(
        jfeat)
    jtrain = FtrlTrainStreamOp(jlr, **FTRL_KW, **env).link_from(
        jfm.transform_stream(MemSourceStreamOp(
            ex.ctr_rows(4000, 2), ex.SCHEMA, batch_size=250, **env)))
    jpred = FtrlPredictStreamOp(
        jlr, vector_col="vec", prediction_col="pred",
        prediction_detail_col="details", reserved_cols=["click"],
        **env).link_from(jtrain, jfm.transform_stream(MemSourceStreamOp(
            ex.ctr_rows(2000, 3), ex.SCHEMA, batch_size=250, **env)))
    jev = EvalBinaryClassStreamOp(label_col="click",
                                  prediction_detail_col="details",
                                  time_interval=2.0, **env).link_from(jpred)
    # the port, through the same calls
    tbatch = TMemB(ex.ctr_rows(1500, 1), ex.SCHEMA)
    tfm = _feature_pipeline("torch", {}).fit(tbatch)
    tfeat = tfm.transform(tbatch)
    tlr = TLR(vector_col="vec", label_col="click", max_iter=15,
              device="cpu", dtype=torch.float64).link_from(tfeat)
    jt = jlr.get_output_table()
    warm = TMemB(model_table_from_reference(jt.to_rows(), jt.schema.types[2]))
    ttrain = TTrain(warm, device="cpu", ship_dtype=torch.float64,
                    **FTRL_KW).link_from(tfm.transform_stream(
                        TMemS(ex.ctr_rows(4000, 2), ex.SCHEMA,
                              batch_size=250)))
    tpred = TPredict(warm, vector_col="vec", prediction_col="pred",
                     prediction_detail_col="details",
                     reserved_cols=["click"]).link_from(
        ttrain, tfm.transform_stream(TMemS(ex.ctr_rows(2000, 3), ex.SCHEMA,
                                           batch_size=250)))
    tev = TEval(label_col="click", prediction_detail_col="details",
                time_interval=2.0).link_from(tpred)
    sink = TSink().link_from(tev)
    TStream.execute()
    out.update(jfm=jfm, jfeat=jfeat, jlr=jlr, jtrain=jtrain, jpred=jpred,
               jev=jev, tfm=tfm, tfeat=tfeat, tlr=tlr, ttrain=ttrain,
               tpred=tpred, tev=tev, tsink=sink.get_and_remove_values())
    yield out
    MLEnvironmentFactory.remove(sid)


def _same_vectors(a, b):
    assert len(a) == len(b)
    for u, v in zip(a, b):
        assert u.n == v.n
        np.testing.assert_array_equal(u.indices, v.indices)
        assert u.values.tobytes() == v.values.tobytes()


def _same_tables(got, want):
    assert got.col_names == want.col_names
    assert list(got.schema.types) == list(want.schema.types)
    for c in got.col_names:
        g, w = got.col(c), want.col(c)
        if want.schema.type_of(c) in ("VECTOR", "SPARSE_VECTOR"):
            _same_vectors(list(g), list(w))
        elif np.asarray(w).dtype.kind == "f":
            assert np.asarray(g).tobytes() == np.asarray(w).tobytes(), c
        else:
            assert [str(v) for v in g] == [str(v) for v in w], c


def test_feature_pipeline_output_bitwise(loops):
    _same_tables(loops["tfeat"].get_output_table(),
                 loops["jfeat"].get_output_table())


def test_warm_start_lr_matches_jax(loops):
    from alink_tpu.operator.common.linear.base import LinearModelDataConverter
    got = TConv.load_table(loops["tlr"].get_output_table())
    want = LinearModelDataConverter.load_table(
        loops["jlr"].get_output_table())
    assert got.coef.shape == want.coef.shape == (513,)
    assert [str(v) for v in got.label_values] == \
        [str(v) for v in want.label_values]
    np.testing.assert_allclose(got.coef, want.coef, rtol=1e-10, atol=1e-12)


def test_ftrl_snapshots_match_jax(loops):
    from alink_tpu.operator.common.linear.base import LinearModelDataConverter
    want = [(t, LinearModelDataConverter.load_table(s).coef)
            for t, s in loops["jtrain"].timed_batches()]
    got = [(t, TConv.load_table(s).coef)
           for t, s in loops["ttrain"].timed_batches()]
    assert [t for t, _ in got] == [t for t, _ in want]
    assert len(got) == 16
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-10, atol=0)


def test_predictions_match_jax(loops):
    want = list(loops["jpred"].timed_batches())
    got = list(loops["tpred"].timed_batches())
    assert [t for t, _ in got] == [t for t, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert g.col_names == w.col_names == ["click", "pred", "details"]
        assert list(g.col("click")) == list(w.col("click"))
        assert [str(v) for v in g.col("pred")] == \
            [str(v) for v in w.col("pred")]
        for a, b in zip(g.col("details"), w.col("details")):
            a, b = json.loads(a), json.loads(b)
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-10, atol=0)


def test_eval_rows_match_jax(loops):
    """The executed sink's rows against the JAX package's eval stream:
    per window and cumulative, equal counts and AUC within 1e-9."""
    want = [r for _, mt in loops["jev"].timed_batches() for r in mt.to_rows()]
    got = loops["tsink"].to_rows()
    assert [r[0] for r in got] == [r[0] for r in want] == \
        ["window", "all"] * 4
    for (_, g), (_, w) in zip(got, want):
        g, w = json.loads(g), json.loads(w)
        for k in ("TruePositive", "FalsePositive", "TrueNegative",
                  "FalseNegative", "TotalSamples", "ConfusionMatrix",
                  "PositiveValue"):
            assert g[k] == w[k], k
        assert abs(g["AUC"] - w["AUC"]) <= 1e-9
    assert json.loads(got[-1][1])["AUC"] > 0.6


def _pipeline_input(ex, pkg, env):
    if pkg == "torch":
        return TMemB(ex.ctr_rows(300, 9), ex.SCHEMA)
    from alink_tpu.operator.batch.source import MemSourceBatchOp
    return MemSourceBatchOp(ex.ctr_rows(300, 9), ex.SCHEMA, **env)


def test_jax_saved_pipeline_loads_in_the_port(loops, tmp_path):
    from alink_tpu.operator.stream.source.sources import MemSourceStreamOp
    ex, env = loops["ex"], loops["env"]
    path = tmp_path / "jax_pipeline.json"
    loops["jfm"].save(str(path))
    obj = json.loads(path.read_text())
    assert obj["stages"][0]["className"] == \
        "alink_tpu.pipeline.feature.StandardScalerModel"
    for src in (str(path), obj):
        model = pipeline_model_from_reference(src)
        assert [type(t).__module__ for t in model.transformers] == \
            ["alink_tpu_torch.pipeline.feature"] * 2
        _same_tables(
            model.transform(_pipeline_input(ex, "torch", env))
            .get_output_table(),
            loops["jfm"].transform(_pipeline_input(ex, "jax", env))
            .get_output_table())
    model = pipeline_model_from_reference(str(path))
    got = [mt for mt in model.transform_stream(TMemS(
        ex.ctr_rows(600, 4), ex.SCHEMA, batch_size=250)).micro_batches()]
    want = [mt for mt in loops["jfm"].transform_stream(MemSourceStreamOp(
        ex.ctr_rows(600, 4), ex.SCHEMA, batch_size=250,
        **env)).micro_batches()]
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _same_tables(g, w)
    with pytest.raises(ValueError, match="not a class of"):
        TPipelineModel.load(str(path))
    bad = dict(obj, stages=[dict(obj["stages"][0],
                                 className="sklearn.pipeline.Pipeline")])
    with pytest.raises(ValueError, match="not a class of alink_tpu"):
        pipeline_model_from_reference(bad)
    # Select and a format transformer (slice 25) load and transform alike
    from alink_tpu.pipeline import Pipeline as JPipeline
    from alink_tpu.pipeline.extras import ColumnsToKv as JColumnsToKv
    from alink_tpu.pipeline.extras import Select as JSelect
    jsel = JPipeline(
        JSelect(clause="site, c1 * 2 + c2 as c3, c2, click"),
        JColumnsToKv(selected_cols=["c3", "c2"], kv_col="kv")).fit(
        _pipeline_input(ex, "jax", env))
    sel_path = tmp_path / "jax_select.json"
    jsel.save(str(sel_path))
    model = pipeline_model_from_reference(str(sel_path))
    assert [type(t).__name__ for t in model.transformers] == \
        ["Select", "ColumnsToKv"]
    assert {type(t).__module__ for t in model.transformers} == \
        {"alink_tpu_torch.pipeline.extras"}
    got = model.transform(_pipeline_input(ex, "torch", env)) \
        .get_output_table()
    assert got.col_names == ["site", "click", "kv"] and got.num_rows == 300
    _same_tables(got, jsel.transform(_pipeline_input(ex, "jax", env))
                 .get_output_table())


def test_port_saved_pipeline_round_trip(loops, tmp_path):
    ex, env = loops["ex"], loops["env"]
    path = tmp_path / "port_pipeline.json"
    loops["tfm"].save(str(path))
    obj = json.loads(path.read_text())
    assert obj["format"] == "alink_tpu.pipeline.v1"
    assert [s["className"] for s in obj["stages"]] == [
        "alink_tpu_torch.pipeline.feature.StandardScalerModel",
        "alink_tpu_torch.pipeline.feature.FeatureHasher"]
    loaded = TPipelineModel.load(str(path))
    _same_tables(
        loaded.transform(_pipeline_input(ex, "torch", env)).get_output_table(),
        loops["tfm"].transform(_pipeline_input(ex, "torch", env))
        .get_output_table())
    _same_tables(
        loaded.transform(_pipeline_input(ex, "torch", env)).get_output_table(),
        loops["jfm"].transform(_pipeline_input(ex, "jax", env))
        .get_output_table())


@pytest.mark.parametrize("labels", [("0", "1"), (0, 1)])
def test_positive_label_agrees_across_ops(labels):
    """String and integer labels alike: the LR's positive label is the
    one the FTRL trainer, the predictor's details and the evaluator
    take."""
    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.common.vector import SparseVector
    from alink_tpu_torch.operator.batch.evaluation.eval_ops import \
        parse_detail_probs
    rng = np.random.RandomState(0)
    n = 200
    y = rng.randint(0, 2, n)
    vecs = np.empty(n, object)
    vecs[:] = [SparseVector(8, [int(v), 7], [1.0, 1.0]) for v in y]
    lab = np.array([labels[v] for v in y], object)
    spec = "vec VECTOR, click " + ("STRING" if isinstance(labels[0], str)
                                   else "LONG")
    table = MTable({"vec": vecs, "click": lab}, spec)
    lr = TLR(vector_col="vec", label_col="click", max_iter=5,
             device="cpu").link_from(TMemB(table))
    model = TConv.load_table(lr.get_output_table())
    assert str(model.label_values[0]) == str(labels[1])
    pred = TPredict(lr, vector_col="vec", prediction_col="pred",
                    prediction_detail_col="details").link_from(
        TTrain(lr, device="cpu", **dict(FTRL_KW, time_interval=100.0))
        .link_from(TMemS(table, batch_size=50)), TMemS(table, batch_size=50))
    out = [mt for mt in pred.micro_batches()]
    pos, p = parse_detail_probs(out[0].col("details"))
    assert str(pos) == str(labels[1])
    got = np.concatenate([np.asarray([str(v) for v in mt.col("pred")])
                          for mt in out])
    assert (got == np.asarray([str(v) for v in lab])).mean() > 0.95
