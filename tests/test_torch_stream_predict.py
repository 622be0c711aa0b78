"""Slice 15 of the port: the stream predict twins and the tree pipeline
on the CPU.

Each of the 20 ``*PredictStreamOp`` twins of numeric rows (the NLP ones
map text: ``tests/test_torch_nlp.py`` holds them; the eight of slice 23
come after them) maps a stream of seeded rows
in 64-row micro-batches with a model the port trained
(``device="cpu"``). Its rows equal the port's batch op's over the whole
table, cell for cell (the same mapper). The JAX package's twin, given
the same model table, gives the same rows at its batch op's tolerance:
cell for cell for the host mappers (linear, tree, scaler; the JAX
package's mappers are the same numpy), and for KMeans the same ids with
the distances within 8 eps (|x| + |c|)^2 of the one-product distance,
as ``tests/test_torch_kmeans.py`` holds the batch op. Then
``pipeline/tree.py``: fit, transform, save and load.

The ten twins of slice 24 (the vector scalers and imputer, the
indexers, OneHot, QuantileDiscretizer, PCA) map rows with a vector, two
string and an index column in 64-row micro-batches: cell for cell their
batch op's, and the JAX package's batch op's on the same model table
(host numpy in both). Their mappers declare an output schema in the
port; the JAX package's twins of them cannot open.

The twins of slice 23 (naive Bayes text and mixed, the multilayer
perceptron, GLM, isotonic and AFT regression, GMM, bisecting KMeans) map
rows of their own fixture (a vector column, a string column, survival
times) in 64-row micro-batches: cell for cell their batch op's. The JAX
package's twins of these families cannot open (their mappers declare no
output schema: ROADMAP Queue C), so the JAX side is its batch op on the
same model table: cell for cell for the host mappers (mixed naive Bayes,
isotonic, AFT); for the mappers that compute on the device (naive Bayes
text, MLP, GLM, GMM: torch against numpy or XLA) the labels and ids
equal, the numbers within rtol 1e-10; bisecting KMeans (the KMeans
mapper, whose twin opens in both packages) cell for cell, twin and batch
op.
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
    "Fm": (tcls.FmClassifierTrainBatchOp,
           dict(feature_cols=FEATS, label_col="bin", device="cpu",
                dtype=torch.float64, num_epochs=3), CLS_OUT),
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


# the twins of text rows, held row for row in tests/test_torch_nlp.py
NLP_TWINS = ("DocCountVectorizer", "DocHashCountVectorizer", "Word2Vec")


def test_every_ported_family_has_its_twin():
    import alink_tpu_torch.operator.stream as tstream
    assert len(tpo.__all__) == 41 == len(CASES) + len(NLP_TWINS) + len(
        SLICE23) + len(SLICE24)
    assert sorted(f"{n}PredictStreamOp"
                  for n in (*CASES, *NLP_TWINS, *SLICE23, *SLICE24)) \
        == tpo.__all__
    assert sorted(tpo.__all__) == sorted(jpo.__all__)
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


# -- the twins of slice 23 ----------------------------------------------------

S23_SCHEMA = ("f0 DOUBLE, f1 DOUBLE, f2 DOUBLE, f3 DOUBLE, c STRING, "
              "vec STRING, cls LONG, y DOUBLE, t DOUBLE, ev DOUBLE")
S23_F64 = dict(device="cpu", dtype=torch.float64)
# twin name -> (train op, its params, the twin's params, host mapper)
SLICE23 = {
    "NaiveBayesText": (tcls.NaiveBayesTextTrainBatchOp,
                       dict(vector_col="vec", label_col="cls", device="cpu"),
                       CLS_OUT, False),
    "NaiveBayes": (tcls.NaiveBayesTrainBatchOp,
                   dict(feature_cols=["f0", "f1", "c"], label_col="cls"),
                   CLS_OUT, True),
    "MultilayerPerceptron": (tcls.MultilayerPerceptronTrainBatchOp,
                             dict(S23_F64, feature_cols=FEATS,
                                  label_col="cls", layers=[5], max_iter=20),
                             CLS_OUT, False),
    "Glm": (treg.GlmTrainBatchOp,
            dict(S23_F64, feature_cols=FEATS, label_col="y", family="poisson"),
            dict(prediction_col="p", link_pred_result_col="eta"), False),
    "IsotonicReg": (treg.IsotonicRegTrainBatchOp,
                    dict(feature_col="f0", label_col="y"), REG_OUT, True),
    "AftSurvivalReg": (treg.AftSurvivalRegTrainBatchOp,
                       dict(S23_F64, feature_cols=FEATS, label_col="t",
                            censor_col="ev", max_iter=20), REG_OUT, True),
    "Gmm": (tclu.GmmTrainBatchOp,
            dict(S23_F64, feature_cols=FEATS, k=3, max_iter=20),
            dict(prediction_col="p", prediction_detail_col="d"), False),
    "BisectingKMeans": (tclu.BisectingKMeansTrainBatchOp,
                        dict(S23_F64, feature_cols=FEATS, k=3,
                             init_mode="RANDOM"),
                        dict(prediction_col="p"), True),
}


def _jax_batch_modules():
    from alink_tpu.operator.batch.classification import mlpc_ops, naive_bayes
    from alink_tpu.operator.batch.clustering import gmm_bisecting
    from alink_tpu.operator.batch.regression import glm_ops
    return {"NaiveBayesText": naive_bayes, "NaiveBayes": naive_bayes,
            "MultilayerPerceptron": mlpc_ops, "Glm": glm_ops,
            "IsotonicReg": glm_ops, "AftSurvivalReg": glm_ops,
            "Gmm": gmm_bisecting, "BisectingKMeans": gmm_bisecting}


jbo = _jax_batch_modules()


def _s23_rows(n=300, seed=0):
    rng = np.random.RandomState(seed)
    cls = rng.randint(0, 3, n)
    X = rng.randn(n, 4) + np.asarray([[0, 0, 0, 0], [3, 0, 1, 0],
                                      [0, 3, 0, -1]])[cls]
    c = np.asarray(["a", "b", "c"])[(cls + (rng.rand(n) < 0.2)) % 3]
    y = rng.poisson(np.exp(0.3 * X[:, 0] - 0.2 * X[:, 1] + 0.5)).astype(float)
    t = np.exp(0.5 + 0.3 * X[:, 0] + 0.4 * np.log(rng.exponential(size=n)))
    ev = (rng.rand(n) > 0.3).astype(float)
    vecs = []
    for k in cls:
        counts = rng.poisson(np.where(np.arange(12) // 4 == k, 2.0, 0.3))
        ix = np.nonzero(counts)[0]
        vecs.append("$12$" + " ".join(f"{i}:{float(counts[i])}" for i in ix))
    return [(*map(float, x), str(cc), v, int(k), float(a), float(b), float(e))
            for x, cc, v, k, a, b, e in zip(X, c, vecs, cls, y, t, ev)]


def _close_cells(a, b):
    """Rows equal but for floats within rtol 1e-10 (JSON details
    compared value by value)."""
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        for u, v in zip(ra, rb):
            if isinstance(u, float):
                np.testing.assert_allclose(u, v, rtol=1e-10, atol=1e-300)
            elif isinstance(u, str) and u.startswith("{"):
                import json
                du, dv = json.loads(u), json.loads(v)
                assert du.keys() == dv.keys()
                np.testing.assert_allclose([du[k] for k in du],
                                           [dv[k] for k in du], rtol=1e-10,
                                           atol=1e-300)
            else:
                assert u == v


@pytest.fixture(scope="module")
def s23_models():
    train = _s23_rows()
    return {name: op_cls(**kw).link_from(TMem(train, S23_SCHEMA))
            .get_output_table()
            for name, (op_cls, kw, _, _) in SLICE23.items()}


@pytest.mark.parametrize("name", sorted(SLICE23))
def test_slice23_twin_equals_batch_op_and_jax_twin(name, s23_models):
    held = _s23_rows(200, seed=1)
    _, _, pkw, host = SLICE23[name]
    model = s23_models[name]
    twin = getattr(tpo, f"{name}PredictStreamOp")
    batch_cls = twin.BATCH_CLS
    import inspect
    takes = "device" in inspect.signature(batch_cls.__init__).parameters
    batch = batch_cls(**pkw, **({"device": "cpu"} if takes else {})) \
        .link_from(TMem(model), TMem(held, S23_SCHEMA)).get_output_table()
    out, names = [], None
    for mt in twin(TMem(model), device="cpu", **pkw).link_from(TMemStream(
            held, S23_SCHEMA, batch_size=MICRO)).micro_batches():
        assert mt.num_rows <= MICRO
        names = names or mt.col_names
        out += mt.to_rows()
    assert names == batch.col_names
    assert _cells(out) == _cells(batch.to_rows())
    jbatch = getattr(jbo[name], f"{name}PredictBatchOp")(**pkw).link_from(
        JMem(_jax_table(model)), JMem(held, S23_SCHEMA)).get_output_table()
    assert jbatch.col_names == names
    if host:
        assert _cells(jbatch.to_rows()) == _cells(out)
    else:
        _close_cells(out, jbatch.to_rows())
    jtwin = getattr(jpo, f"{name}PredictStreamOp")(
        JMem(_jax_table(model)), prediction_col="p").link_from(JMemStream(
            held, S23_SCHEMA, batch_size=MICRO))
    if name == "BisectingKMeans":       # the KMeans mapper: it opens
        assert _cells([r for mt in jtwin.micro_batches()
                       for r in mt.to_rows()]) == _cells(out)
        return
    with pytest.raises(NotImplementedError):   # the JAX package's twin
        list(jtwin.micro_batches())


# -- the twins of slice 24 ----------------------------------------------------

S24_SCHEMA = "f0 DOUBLE, f1 DOUBLE, c STRING, d STRING, vec STRING, idx LONG"
S24_VEC = dict(selected_col="vec", output_col="vo")
# twin name -> (train op's module and name, its params, the twin's params)
SLICE24 = {
    "VectorStandardScaler": ("dataproc.vector_ops",
                             "VectorStandardScalerTrainBatchOp",
                             dict(selected_col="vec"), S24_VEC),
    "VectorMinMaxScaler": ("dataproc.vector_ops",
                           "VectorMinMaxScalerTrainBatchOp",
                           dict(selected_col="vec"), S24_VEC),
    "VectorMaxAbsScaler": ("dataproc.vector_ops",
                           "VectorMaxAbsScalerTrainBatchOp",
                           dict(selected_col="vec"), S24_VEC),
    "VectorImputer": ("dataproc.vector_ops", "VectorImputerTrainBatchOp",
                      dict(selected_col="vec"), S24_VEC),
    "StringIndexer": ("dataproc.indexers", "StringIndexerTrainBatchOp",
                      dict(selected_col="c",
                           string_order_type="frequency_desc"),
                      dict(selected_col="c", output_col="ci")),
    "MultiStringIndexer": ("dataproc.indexers",
                           "MultiStringIndexerTrainBatchOp",
                           dict(selected_cols=["c", "d"]),
                           dict(selected_cols=["c", "d"],
                                output_cols=["ci", "di"])),
    "IndexToString": ("dataproc.indexers", "StringIndexerTrainBatchOp",
                      dict(selected_col="c", string_order_type="alphabet_asc"),
                      dict(selected_col="idx", output_col="cs")),
    "OneHot": ("feature.feature_ops", "OneHotTrainBatchOp",
               dict(selected_cols=["c", "d", "idx"]), dict(output_col="oh")),
    "QuantileDiscretizer": ("feature.feature_ops",
                            "QuantileDiscretizerTrainBatchOp",
                            dict(selected_cols=["f0", "f1"], num_buckets=5),
                            {}),
    "Pca": ("feature.feature_ops", "PcaTrainBatchOp",
            dict(selected_cols=["f0", "f1"], k=1),
            dict(selected_cols=["f0", "f1"], output_col="p")),
}


def _s24_rows(n=300, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 2) @ [[1.0, 0.6], [0.0, 0.8]]
    c = np.asarray(["x", "y", "z", "w"])[rng.randint(0, 4, n)]
    d = np.asarray(["p", "q"])[rng.randint(0, 2, n)]
    V = rng.randn(n, 3) * [1.0, 5.0, 0.1] + [0.0, 2.0, -1.0]
    V[rng.rand(n, 3) < 0.05] = np.nan
    vec = [" ".join(repr(float(v)) for v in r) for r in V]
    idx = rng.randint(-1, 6, n)
    return [(float(a), float(b), str(u), str(w), v, int(i))
            for a, b, u, w, v, i in zip(X[:, 0], X[:, 1], c, d, vec, idx)]


def _s24_train_op(name, module):
    import importlib
    mod, cls = SLICE24[name][:2]
    return getattr(importlib.import_module(f"{module}.{mod}"), cls)


@pytest.fixture(scope="module")
def s24_models():
    train = _s24_rows()
    out = {}
    for name, (_, _, kw, _) in SLICE24.items():
        op = _s24_train_op(name, "alink_tpu_torch.operator.batch")
        if name == "QuantileDiscretizer":
            kw = dict(kw, device="cpu")
        out[name] = op(**kw).link_from(TMem(train, S24_SCHEMA)) \
            .get_output_table()
    return out


@pytest.mark.parametrize("name", sorted(SLICE24))
def test_slice24_twin_equals_batch_op_and_jax_batch_op(name, s24_models):
    """Cell for cell: the twin over 64-row micro-batches, the port's
    batch op and the JAX package's batch op on the same model table
    (and that model table equals the JAX package's own training)."""
    train, held = _s24_rows(), _s24_rows(200, seed=1)
    _, _, tkw, pkw = SLICE24[name]
    model = s24_models[name]
    jop = _s24_train_op(name, "alink_tpu.operator.batch")(**tkw).link_from(
        JMem(train, S24_SCHEMA))
    assert jop.get_output_table().to_rows() == model.to_rows()
    twin = getattr(tpo, f"{name}PredictStreamOp")
    batch = twin.BATCH_CLS(**pkw).link_from(
        TMem(model), TMem(held, S24_SCHEMA)).get_output_table()
    out, names = [], None
    for mt in twin(TMem(model), device="cpu", **pkw).link_from(TMemStream(
            held, S24_SCHEMA, batch_size=MICRO)).micro_batches():
        assert mt.num_rows <= MICRO
        names = names or mt.col_names
        out += mt.to_rows()
    assert names == batch.col_names
    assert _cells(out) == _cells(batch.to_rows())
    jres = _jax_batch_op(name, pkw).link_from(
        JMem(_jax_table(model)), JMem(held, S24_SCHEMA)).get_output_table()
    assert jres.col_names == names
    assert _cells(jres.to_rows()) == _cells(out)
    jtwin = getattr(jpo, f"{name}PredictStreamOp")(
        JMem(_jax_table(model)), **pkw).link_from(JMemStream(
            held, S24_SCHEMA, batch_size=MICRO))
    with pytest.raises(NotImplementedError):   # the JAX package's twin
        list(jtwin.micro_batches())


def _jax_batch_op(name, pkw):
    import importlib
    mod = importlib.import_module(f"alink_tpu.operator.batch.{SLICE24[name][0]}")
    return getattr(mod, f"{name}PredictBatchOp")(**pkw)


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
