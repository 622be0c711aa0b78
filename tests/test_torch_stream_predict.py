"""Slice 15 of the port: the stream predict twins and the tree pipeline
on the CPU.

Each of the 19 ``*PredictStreamOp`` twins maps a stream of seeded rows
in 64-row micro-batches with a model the port trained
(``device="cpu"``). Its rows equal the port's batch op's over the whole
table, cell for cell (the same mapper). The JAX package's twin, given
the same model table, gives the same rows at its batch op's tolerance:
cell for cell for the host mappers (linear, tree, scaler; the JAX
package's mappers are the same numpy), and for KMeans the same ids with
the distances within 8 eps (|x| + |c|)^2 of the one-product distance,
as ``tests/test_torch_kmeans.py`` holds the batch op. Then
``pipeline/tree.py``: fit, transform, save and load.
"""

import numpy as np
import pytest
import torch

from alink_tpu.common.mtable import MTable as JMTable
from alink_tpu.common.types import TableSchema as JSchema
from alink_tpu.operator.batch.source import MemSourceBatchOp as JMem
from alink_tpu.operator.stream import predict_ops as jpo
from alink_tpu.operator.stream.source import MemSourceStreamOp as JMemStream
from alink_tpu_torch.operator.batch import classification as tcls
from alink_tpu_torch.operator.batch import clustering as tclu
from alink_tpu_torch.operator.batch import regression as treg
from alink_tpu_torch.operator.batch.dataproc import scalers as tsc
from alink_tpu_torch.operator.batch.source import MemSourceBatchOp as TMem
from alink_tpu_torch.operator.stream import predict_ops as tpo
from alink_tpu_torch.operator.stream.source import \
    MemSourceStreamOp as TMemStream
from alink_tpu_torch.pipeline import PipelineModel
from alink_tpu_torch.pipeline import tree as ptree

FEATS = ["f0", "f1", "f2", "f3"]
SCHEMA = ("f0 DOUBLE, f1 DOUBLE, f2 DOUBLE, f3 DOUBLE, g DOUBLE, "
          "bin LONG, cls LONG, y DOUBLE")
MICRO = 64
LIN = dict(feature_cols=FEATS, device="cpu", dtype=torch.float64,
           max_iter=30)
TREE = dict(feature_cols=FEATS, device="cpu", max_depth=3)
ENSEMBLE = dict(TREE, num_trees=3)
CLS_OUT = dict(prediction_col="p", prediction_detail_col="d")
REG_OUT = dict(prediction_col="p")

# twin name -> (train op, its params, the twin's params)
CASES = {
    "LogisticRegression": (tcls.LogisticRegressionTrainBatchOp,
                           dict(LIN, label_col="bin"), CLS_OUT),
    "LinearSvm": (tcls.LinearSvmTrainBatchOp, dict(LIN, label_col="bin"),
                  CLS_OUT),
    "Softmax": (tcls.SoftmaxTrainBatchOp, dict(LIN, label_col="cls"),
                CLS_OUT),
    "Perceptron": (tcls.PerceptronTrainBatchOp, dict(LIN, label_col="bin"),
                   CLS_OUT),
    "LinearReg": (treg.LinearRegTrainBatchOp, dict(LIN, label_col="y"),
                  REG_OUT),
    "RidgeReg": (treg.RidgeRegTrainBatchOp,
                 dict(LIN, label_col="y", lambda_=0.1), REG_OUT),
    "LassoReg": (treg.LassoRegTrainBatchOp,
                 dict(LIN, label_col="y", lambda_=0.01), REG_OUT),
    "LinearSvr": (treg.LinearSvrTrainBatchOp,
                  dict(LIN, label_col="y", tau=0.1), REG_OUT),
    "Gbdt": (tcls.GbdtTrainBatchOp, dict(ENSEMBLE, label_col="bin"),
             CLS_OUT),
    "GbdtReg": (tcls.GbdtRegTrainBatchOp, dict(ENSEMBLE, label_col="y"),
                REG_OUT),
    "RandomForest": (tcls.RandomForestTrainBatchOp,
                     dict(ENSEMBLE, label_col="cls"), CLS_OUT),
    "RandomForestReg": (tcls.RandomForestRegTrainBatchOp,
                        dict(ENSEMBLE, label_col="y"), REG_OUT),
    "DecisionTree": (tcls.DecisionTreeTrainBatchOp,
                     dict(TREE, label_col="cls"), CLS_OUT),
    "DecisionTreeReg": (tcls.DecisionTreeRegTrainBatchOp,
                        dict(TREE, label_col="y"), REG_OUT),
    "KMeans": (tclu.KMeansTrainBatchOp,
               dict(feature_cols=FEATS, k=3, device="cpu",
                    dtype=torch.float64), dict(prediction_col="p")),
    "StandardScaler": (tsc.StandardScalerTrainBatchOp,
                       dict(selected_cols=["f0", "f1", "g"]), {}),
    "MinMaxScaler": (tsc.MinMaxScalerTrainBatchOp,
                     dict(selected_cols=["f0", "f1", "g"]), {}),
    "MaxAbsScaler": (tsc.MaxAbsScalerTrainBatchOp,
                     dict(selected_cols=["f0", "f1", "g"]), {}),
    "Imputer": (tsc.ImputerTrainBatchOp,
                dict(selected_cols=["f0", "g"]), {}),
}


def _rows(n=400, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 4)
    X[:, 1] += 3.0 * (rng.rand(n) < 0.5)
    g = np.where(rng.rand(n) < 0.1, np.nan, rng.randn(n) * 2 + 1)
    logit = X @ [1.5, -1.0, 0.5, 0.0] + 0.3 * rng.randn(n)
    cls = np.digitize(logit, [-1.0, 1.0])
    y = X @ [0.7, -0.2, 0.4, 1.1] + 0.1 * rng.randn(n)
    return [(*map(float, x), float(gg), int(v > 0), int(c), float(t))
            for x, gg, v, c, t in zip(X, g, logit, cls, y)]


@pytest.fixture(scope="module")
def data():
    return _rows(), _rows(n=300, seed=1)


@pytest.fixture(scope="module")
def models(data):
    train, _ = data
    out = {}
    for name, (op_cls, kw, _) in CASES.items():
        out[name] = op_cls(**kw).link_from(TMem(train, SCHEMA)) \
            .get_output_table()
    return out


def _jax_table(t):
    return JMTable(t.to_rows(), JSchema(list(t.schema.names),
                                        list(t.schema.types)))


def _stream_rows(op, rows, stream_cls):
    out, names = [], None
    for mt in op.link_from(stream_cls(rows, SCHEMA,
                                      batch_size=MICRO)).micro_batches():
        assert mt.num_rows <= MICRO
        names = names or mt.col_names
        assert mt.col_names == names
        out += mt.to_rows()
    return names, out


def _cells(rows):
    return [tuple(repr(v) for v in r) for r in rows]


def test_every_ported_family_has_its_twin():
    import alink_tpu_torch.operator.stream as tstream
    assert len(tpo.__all__) == 19 == len(CASES)
    assert sorted(f"{n}PredictStreamOp" for n in CASES) == tpo.__all__
    # the package's lazily exported names are the module's twins
    assert sorted(k for k, v in tstream._LAZY.items()
                  if v == ".predict_ops") == tpo.__all__
    for name in tpo.__all__:
        twin = getattr(tpo, name)
        assert twin.MAPPER_CLS is twin.BATCH_CLS.MAPPER_CLS
        assert set(twin.BATCH_CLS.param_infos()) <= set(twin.param_infos())
        assert hasattr(jpo, name)


@pytest.mark.parametrize("name", sorted(CASES))
def test_twin_equals_batch_op_and_jax_twin(name, data, models):
    _, held = data
    _, _, pkw = CASES[name]
    model = models[name]
    twin = getattr(tpo, f"{name}PredictStreamOp")
    batch_cls = twin.BATCH_CLS
    bkw = dict(pkw, device="cpu") if name == "KMeans" else dict(pkw)
    if name == "KMeans":
        bkw["prediction_distance_col"] = "dist"
    batch = batch_cls(**bkw).link_from(TMem(model), TMem(held, SCHEMA)) \
        .get_output_table()
    names, rows = _stream_rows(twin(TMem(model), device="cpu", **(
        dict(pkw, prediction_distance_col="dist") if name == "KMeans"
        else pkw)), held, TMemStream)
    assert names == batch.col_names
    assert _cells(rows) == _cells(batch.to_rows())
    # the JAX package's twin on the same model table
    jnames, jrows = _stream_rows(
        getattr(jpo, f"{name}PredictStreamOp")(JMem(_jax_table(model)),
                                               **pkw),
        held, JMemStream)
    if name != "KMeans":
        assert jnames == names
        assert _cells(jrows) == _cells(rows)
        return
    assert jnames == names[:-1]
    ids = [r[-2] for r in rows]
    assert ids == [r[-1] for r in jrows]
    # the JAX twin gives no distance: the JAX batch op does
    from alink_tpu.operator.batch.clustering.kmeans_ops import \
        KMeansPredictBatchOp as JPredict
    jb = JPredict(prediction_col="p", prediction_distance_col="dist") \
        .link_from(JMem(_jax_table(model)), JMem(held, SCHEMA)) \
        .get_output_table()
    assert list(jb.col("p")) == ids
    d = np.asarray([r[-1] for r in rows])
    jd = np.asarray(jb.col("dist"), np.float64)
    X = np.asarray([r[:4] for r in held])
    cent = tclu.KMeansModelDataConverter().load_model(model).centroids
    band = np.finfo(np.float64).eps * (np.linalg.norm(X, axis=1) + np.linalg
                                       .norm(cent[ids], axis=1)) ** 2
    assert (np.abs(d ** 2 - jd ** 2) <= 8 * band).all()


def test_twins_default_to_the_card(monkeypatch, models):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in tpo.__all__:
        with pytest.raises(RuntimeError, match="CUDA"):
            getattr(tpo, name)(TMem(models["LogisticRegression"]))


def test_kmeans_twin_maps_on_its_device(models, data):
    """The KMeans twin hands its device to the mapper; the host mappers
    take none."""
    _, held = data
    op = tpo.KMeansPredictStreamOp(TMem(models["KMeans"]), device="cpu",
                                   prediction_col="p")
    op.link_from(TMemStream(held, SCHEMA, batch_size=MICRO))
    mt = next(iter(op.micro_batches()))
    assert mt.num_rows == MICRO
    assert op._mapper.device == torch.device("cpu")


# -- pipeline/tree.py --------------------------------------------------------

@pytest.mark.parametrize("name,label", [
    ("GbdtClassifier", "bin"), ("GbdtRegressor", "y"),
    ("RandomForestClassifier", "cls"), ("RandomForestRegressor", "y"),
    ("DecisionTreeClassifier", "cls"), ("DecisionTreeRegressor", "y")])
def test_tree_pipeline_fit_transform_save_load(name, label, data, tmp_path):
    train, held = data
    est_cls = getattr(ptree, name)
    pred_kw = dict(prediction_col="p")
    if label != "y":
        pred_kw["prediction_detail_col"] = "d"
    trees = {} if name.startswith("DecisionTree") else {"num_trees": 3}
    est = est_cls(feature_cols=FEATS, label_col=label, max_depth=3,
                  device="cpu", **trees, **pred_kw)
    model = est.fit(TMem(train, SCHEMA))
    assert type(model).__name__ == name + "Model"
    assert type(model).__module__ == "alink_tpu_torch.pipeline.tree"
    op = est.TRAIN_OP_CLS(feature_cols=FEATS, label_col=label, max_depth=3,
                          device="cpu", **trees).link_from(
        TMem(train, SCHEMA))
    assert model.get_model_data().to_rows() == op.get_output_table().to_rows()
    got = model.transform(TMem(held, SCHEMA)).get_output_table()
    want = tcls.GbdtPredictBatchOp(**pred_kw).link_from(
        op, TMem(held, SCHEMA)).get_output_table()
    assert got.col_names == want.col_names
    assert _cells(got.to_rows()) == _cells(want.to_rows())
    path = str(tmp_path / "tree.json")
    PipelineModel(model).save(path)
    loaded = PipelineModel.load(path)
    assert type(loaded.transformers[0]) is type(model)
    again = loaded.transform(TMem(held, SCHEMA)).get_output_table()
    assert _cells(again.to_rows()) == _cells(got.to_rows())
