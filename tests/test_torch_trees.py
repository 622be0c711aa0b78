"""Slice 3 of the port: tree training and serving on the CPU, against the
JAX package.

The port's ``gbdt_train`` and ``forest_train`` run the level histogram's
plain version, which is bitwise the JAX package's CPU default. The bin
prefix sums and the classification sigmoid round differently from
XLA's, so trees are held to the JAX package's own gate between its
histogram paths (``tests/test_perf_kernels.py::
test_xla_and_pallas_parity_with_default``): identical split features,
split bins and split masks; leaf values, loss curve and importances
within rtol 1e-4. The JAX side runs under an explicit 1-device
``MLEnvironment``. Serving is exact: a model table saved by either
package loads in the other field for field, ``GbdtPredictBatchOp``
gives the JAX package's output, and ``CompiledPredictor`` shipping
float64 gives ``map_table``'s scores bit for bit at every bucket.
"""

import json

import jax
import numpy as np
import pytest
import torch

from alink_tpu.common.mlenv import MLEnvironment as JEnv
from alink_tpu.common.mlenv import MLEnvironmentFactory as JFactory
from alink_tpu_torch.common.mlenv import MLEnvironment as TEnv
from alink_tpu_torch.common.mtable import MTable as TMTable
from alink_tpu_torch.common.params import Params as TParams
from alink_tpu_torch.common.types import TableSchema as TSchema
from alink_tpu_torch.model.interop import tree_model_from_numpy
from alink_tpu_torch.operator.batch.classification import tree_ops as tops
from alink_tpu_torch.operator.batch.source import MemSourceBatchOp as TMem
from alink_tpu_torch.operator.common.tree import hist as thist
from alink_tpu_torch.operator.common.tree import trainers as ttr
from alink_tpu_torch.serving import CompiledPredictor as TPredictor

RTOL = 1e-4


@pytest.fixture(scope="module")
def jenv():
    return JEnv(parallelism=1, devices=jax.devices()[:1])


@pytest.fixture(scope="module")
def tenv():
    return TEnv(device="cpu")


@pytest.fixture
def jax_default_1dev(jenv):
    """The JAX ops train on the default session: make it 1-device for
    the test, and put the 8-device one back after."""
    prev = JFactory.get_default()
    JFactory.set_default(jenv)
    yield jenv
    JFactory.set_default(prev)


def _gbdt_fixture(n=1500, F=6, seed=0):
    """tests/test_perf_kernels.py::_gbdt_fixture"""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.float32)
    return X, y


def _cat_fixture(n=3000):
    """The data of tests/test_trees.py::test_gbdt_categorical_subset_split:
    a label driven by a scattered subset of 12 categories, xor a
    threshold on one continuous column."""
    rng = np.random.RandomState(0)
    cats = np.asarray(list("ABCDEFGHIJKL"))
    cvals = cats[rng.randint(0, 12, n)]
    x0 = rng.randn(n)
    y = ((np.isin(cvals, ["B", "F", "K"])) ^ (x0 > 1.5)).astype(int)
    return cvals, x0, y


def _same_structure(a, b, n_split):
    """a, b: (features, split_bins, split_masks, ...) of the two packages."""
    for i, name in enumerate(("features", "split_bins", "split_masks")):
        x, y = np.asarray(a[i]), np.asarray(b[i])
        assert x.shape == y.shape, name
        assert np.array_equal(x, y), name
    assert (np.asarray(a[0]) >= 0).sum() >= n_split      # real trees


def _close(a, b, name):
    np.testing.assert_allclose(np.asarray(b, np.float64),
                               np.asarray(a, np.float64), rtol=RTOL,
                               atol=1e-6, err_msg=name)


def _gbdt_both(jenv, tenv, X, y, reg, cat_mask=None, **kw):
    from alink_tpu.operator.common.tree.trainers import (
        TreeTrainParams as JP, gbdt_train as jgbdt)
    a = jgbdt(X, y, JP(**kw), reg, env=jenv, cat_mask=cat_mask)
    b = ttr.gbdt_train(X, y, ttr.TreeTrainParams(**kw), reg, env=tenv,
                       cat_mask=cat_mask)
    return a, b


@pytest.mark.parametrize("reg", [False, True], ids=["binary", "regression"])
def test_gbdt_train_matches_jax(jenv, tenv, reg):
    X, y = _gbdt_fixture()
    if reg:
        y = (2 * X[:, 0] + X[:, 1] ** 2).astype(np.float32)
    a, b = _gbdt_both(jenv, tenv, X, y, reg, num_trees=3, max_depth=4,
                      n_bins=16, learning_rate=0.3)
    _same_structure(a, b, n_split=3 * 7)
    np.testing.assert_array_equal(np.asarray(a[4]), b[4])      # edges
    assert a[5] == b[5]                                        # base score
    _close(a[3], b[3], "leaf values")
    _close(a[6], b[6], "loss curve")
    _close(a[7], b[7], "importance")
    assert b[3].dtype == np.float32 and b[6].dtype == np.float32


def test_gbdt_categorical_matches_jax(jenv, tenv):
    cvals, x0, y = _cat_fixture()
    code = np.searchsorted(np.asarray(list("ABCDEFGHIJKL")), cvals)
    X = np.stack([x0, code.astype(np.float64)], axis=1)
    cat_mask = np.asarray([False, True])
    a, b = _gbdt_both(jenv, tenv, X, y.astype(np.float32), False,
                      cat_mask=cat_mask, num_trees=5, max_depth=2)
    _same_structure(a, b, n_split=5)
    _close(a[3], b[3], "leaf values")
    _close(a[6], b[6], "loss curve")


@pytest.mark.parametrize("kind", ["gini", "variance"])
def test_decision_tree_matches_jax(jenv, tenv, kind):
    from alink_tpu.operator.common.tree.trainers import (
        TreeTrainParams as JP, forest_train as jforest)
    X, _ = _gbdt_fixture(n=1200, F=5, seed=4)
    if kind == "gini":
        y = (X[:, 0] > 0).astype(int) + (X[:, 2] > 0.5).astype(int)
        stats = np.concatenate([np.eye(3)[y], np.ones((len(y), 1))], 1)
    else:
        y = X[:, 0] * 3 + np.sin(2 * X[:, 1])
        stats = np.stack([y, y * y, np.ones_like(y)], 1)
    kw = dict(num_trees=1, max_depth=5, n_bins=32, min_samples_leaf=2)
    a = jforest(X, stats, JP(**kw), kind, env=jenv)
    b = ttr.forest_train(X, stats, ttr.TreeTrainParams(**kw), kind, env=tenv)
    _same_structure(a, b, n_split=10)
    _close(a[3], b[3], "leaf values")
    _close(a[5], b[5], "importance")


def test_argmax_takes_the_first_maximum():
    """Both libraries pick the first of tied gains, and index 0 for a
    node whose gains are all -inf (an unsplit node)."""
    import jax.numpy as jnp
    g = np.asarray([[-np.inf, -np.inf, -np.inf], [1.0, 2.0, 2.0],
                    [3.0, 3.0, 0.0]], np.float32)
    assert np.array_equal(np.asarray(jnp.argmax(jnp.asarray(g), axis=1)),
                          torch.argmax(torch.from_numpy(g), dim=1).numpy())
    assert torch.argmax(torch.from_numpy(g), dim=1).tolist() == [0, 1, 0]
    # an unsplittable node: every row identical -> no split, feature -1
    binned = torch.zeros((16, 3), dtype=torch.int32)
    stats = torch.ones((16, 3))
    f, b, m, v, nid, lh, gains = thist.build_tree(
        binned, stats, 2, 4, thist.make_xgb_gain(1.0), thist.make_xgb_leaf(1.0))
    assert f.tolist() == [-1, -1, -1] and b.tolist() == [0, 0, 0]
    assert not m.any() and nid.tolist() == [0] * 16
    assert gains.tolist() == [0.0, 0.0, 0.0]


# ---------------------------------------------------------------------------
# the batch operators and the model table
# ---------------------------------------------------------------------------

def _cat_tables():
    cvals, x0, y = _cat_fixture(n=1200)
    rows = [(str(c), float(v), int(t)) for c, v, t in zip(cvals, x0, y)]
    schema = "cat STRING, x0 DOUBLE, label LONG"
    return rows, schema


@pytest.fixture(scope="module")
def trained(jenv):
    """A JAX-package GBDT model (categorical) and a regression forest,
    trained by its ops on the 1-device session."""
    from alink_tpu.operator.batch.classification.tree_ops import (
        GbdtTrainBatchOp, RandomForestRegTrainBatchOp)
    from alink_tpu.operator.batch.source import MemSourceBatchOp
    prev = JFactory.get_default()
    JFactory.set_default(jenv)
    try:
        rows, schema = _cat_tables()
        src = MemSourceBatchOp(rows, schema)
        gbdt = GbdtTrainBatchOp(feature_cols=["x0"], categorical_cols=["cat"],
                                label_col="label", num_trees=4,
                                max_depth=3).link_from(src)
        X, _ = _gbdt_fixture(n=600, F=4, seed=7)
        yr = X[:, 0] - 2 * X[:, 3]
        rrows = [tuple(map(float, x)) + (float(t),) for x, t in zip(X, yr)]
        rschema = "a DOUBLE, b DOUBLE, c DOUBLE, d DOUBLE, y DOUBLE"
        rf = RandomForestRegTrainBatchOp(
            feature_cols=["a", "b", "c", "d"], label_col="y", num_trees=3,
            max_depth=3, subsampling_ratio=1.0,
            feature_subsampling_ratio=1.0).link_from(
            MemSourceBatchOp(rrows, rschema))
    finally:
        JFactory.set_default(prev)
    return {"gbdt": (gbdt, rows, schema), "rf": (rf, rrows, rschema)}


def _fields(m):
    return {k: getattr(m, k) for k in (
        "algo", "is_regression", "max_depth", "features", "thresholds",
        "leaf_values", "base_score", "learning_rate", "labels",
        "feature_cols", "vector_col", "label_type", "split_masks",
        "cat_cols", "cat_vocabs", "importances")}


def _assert_same_fields(a, b):
    fa, fb = _fields(a), _fields(b)
    for k in fa:
        if isinstance(fa[k], np.ndarray) or isinstance(fb[k], np.ndarray):
            x, y = np.asarray(fa[k]), np.asarray(fb[k])
            assert x.dtype == y.dtype and np.array_equal(x, y), k
        else:
            assert fa[k] == fb[k], k


@pytest.mark.parametrize("which", ["gbdt", "rf"])
def test_model_tables_load_both_ways(trained, which):
    from alink_tpu.common.mtable import MTable as JMTable
    from alink_tpu.common.types import TableSchema as JSchema
    from alink_tpu.operator.batch.classification.tree_ops import \
        TreeModelDataConverter as JConv
    jt = trained[which][0].get_output_table()
    tt = _port_table(trained[which][0])
    jm = JConv().load_model(jt)
    tm = tops.TreeModelDataConverter().load_model(tt)
    _assert_same_fields(jm, tm)
    # and back: the port's table, saved from its own model, loads in JAX
    back = tops.TreeModelDataConverter().save_model(tm)
    jm2 = JConv().load_model(JMTable(back.to_rows(), JSchema(
        list(back.schema.names), list(back.schema.types))))
    _assert_same_fields(jm2, tm)


def _port_table(jop):
    jt = jop.get_output_table()
    return TMTable(jt.to_rows(), TSchema(list(jt.schema.names),
                                         list(jt.schema.types)))


@pytest.mark.parametrize("which", ["gbdt", "rf"])
def test_predict_op_matches_jax(trained, which):
    from alink_tpu.operator.batch.classification.tree_ops import \
        GbdtPredictBatchOp as JPredict
    from alink_tpu.operator.batch.source import MemSourceBatchOp
    jop, rows, schema = trained[which]
    kw = dict(prediction_col="p", prediction_detail_col="d")
    if which == "rf":
        kw = dict(prediction_col="p")
    ref = JPredict(**kw).link_from(jop, MemSourceBatchOp(rows, schema)) \
        .get_output_table()
    got = tops.GbdtPredictBatchOp(**kw).link_from(
        TMem(_port_table(jop)), TMem(rows, schema)).get_output_table()
    assert got.col_names == ref.col_names
    for c in got.col_names:
        assert [repr(v) for v in got.col(c)] == [repr(v) for v in ref.col(c)], c


def _host_scores(m, X):
    """map_table's score loop, kept apart to compare raw scores."""
    cat_mask = (np.asarray([c in m.cat_cols for c in m.feature_cols])
                if m.cat_cols else None)
    T = m.features.shape[0]
    leaves = [thist.tree_apply_values(
        X, m.features[t], m.thresholds[t], m.max_depth, cat_mask=cat_mask,
        split_masks=m.split_masks[t] if m.split_masks is not None else None)
        for t in range(T)]
    if m.algo == "gbdt":
        s = np.full(X.shape[0], m.base_score)
        for t in range(T):
            s += m.learning_rate * m.leaf_values[t][leaves[t]]
        return s
    s = np.zeros((X.shape[0],) + m.leaf_values.shape[2:])
    for t in range(T):
        s += m.leaf_values[t][leaves[t]]
    return s


def _mapper(table, data_schema, **params):
    mp = tops.TreeModelMapper(table.schema, data_schema, TParams(params))
    mp.load_model(table)
    return mp


@pytest.mark.parametrize("which", ["gbdt", "rf"])
def test_compiled_predictor_f64_bitwise_to_map_table(trained, which):
    jop, rows, schema = trained[which]
    data = TMem(rows, schema).get_output_table()
    params = {"prediction_col": "p"}
    if which == "gbdt":
        params["prediction_detail_col"] = "d"
    mp = _mapper(_port_table(jop), data.schema, **params)
    host = mp.map_table(data)
    want = _host_scores(mp.model, mp._encode_matrix(data))
    for buckets in ((1, 4, 16), (7,), (64, 512)):
        pred = TPredictor(mp, buckets=buckets, device="cpu",
                          ship_dtype=torch.float64)
        got = pred.predict_scores(data)
        assert got.dtype == np.float64
        assert np.array_equal(got.view(np.int64), want.view(np.int64)), \
            buckets
        out = pred.predict_table(data)
        for c in out.col_names:
            assert [repr(v) for v in out.col(c)] == \
                [repr(v) for v in host.col(c)], (buckets, c)


def test_classification_forest_serving_bitwise(tenv):
    """A 3-class forest (gini leaves of 3 fractions), trained by the
    port, served in float64: the summed leaf fractions equal the host
    loop's, and the labels and details map_table's."""
    X, _ = _gbdt_fixture(n=400, F=3, seed=9)
    y = (X[:, 0] > 0).astype(int) + (X[:, 1] > 0.3).astype(int)
    rows = [tuple(map(float, x)) + (["lo", "mid", "hi"][t],)
            for x, t in zip(X, y)]
    src = TMem(rows, "a DOUBLE, b DOUBLE, c DOUBLE, label STRING")
    op = tops.RandomForestTrainBatchOp(
        feature_cols=["a", "b", "c"], label_col="label", num_trees=4,
        max_depth=3, device="cpu").link_from(src)
    data = src.get_output_table()
    mp = _mapper(op.get_output_table(), data.schema, prediction_col="p",
                 prediction_detail_col="d")
    want = _host_scores(mp.model, mp._encode_matrix(data))
    pred = TPredictor(mp, buckets=(8, 128), device="cpu",
                      ship_dtype=torch.float64)
    got = pred.predict_scores(data)
    assert got.shape == (400, 3)
    assert np.array_equal(got.view(np.int64), want.view(np.int64))
    host = mp.map_table(data)
    out = pred.predict_table(data)
    assert list(out.col("p")) == list(host.col("p"))
    assert list(out.col("d")) == list(host.col("d"))
    acc = np.mean(np.asarray(out.col("p")) ==
                  np.asarray(["lo", "mid", "hi"])[y])
    assert acc > 0.8


def test_ops_pipeline_matches_jax(jax_default_1dev):
    """MemSource -> GbdtTrainBatchOp -> GbdtPredictBatchOp in both
    packages: the same trees, model tables within the leaf tolerance,
    the same labels, details within rtol 1e-4, the same loss-curve side
    output within rtol 1e-4."""
    from alink_tpu.operator.batch.classification.tree_ops import (
        GbdtPredictBatchOp as JPredict, GbdtTrainBatchOp as JTrain,
        TreeModelDataConverter as JConv)
    from alink_tpu.operator.batch.source import MemSourceBatchOp
    rows, schema = _cat_tables()
    kw = dict(feature_cols=["x0"], categorical_cols=["cat"],
              label_col="label", num_trees=4, max_depth=3)
    jtrain = JTrain(**kw).link_from(MemSourceBatchOp(rows, schema))
    ttrain = tops.GbdtTrainBatchOp(device="cpu", **kw).link_from(
        TMem(rows, schema))
    jm = JConv().load_model(jtrain.get_output_table())
    tm = tops.TreeModelDataConverter().load_model(ttrain.get_output_table())
    for k in ("features", "thresholds", "split_masks"):
        assert np.array_equal(getattr(jm, k), getattr(tm, k)), k
    _close(jm.leaf_values, tm.leaf_values, "leaf values")
    _close(jm.importances, tm.importances, "importances")
    assert (jm.labels, jm.cat_vocabs, jm.feature_cols) == \
        (tm.labels, tm.cat_vocabs, tm.feature_cols)
    _close(jtrain.get_side_output(0).get_output_table().col("loss"),
           ttrain.get_side_output(0).get_output_table().col("loss"), "loss")
    pk = dict(prediction_col="p", prediction_detail_col="d")
    jout = JPredict(**pk).link_from(jtrain, MemSourceBatchOp(rows, schema)) \
        .get_output_table()
    tout = tops.GbdtPredictBatchOp(**pk).link_from(ttrain, TMem(rows, schema)) \
        .get_output_table()
    assert list(jout.col("p")) == list(tout.col("p"))
    jd = np.asarray([list(json.loads(s).values()) for s in jout.col("d")])
    td = np.asarray([list(json.loads(s).values()) for s in tout.col("d")])
    _close(jd, td, "details")
    info = dict(zip(ttrain.get_model_info().col("item"),
                    ttrain.get_model_info().col("value")))
    assert info["algo"] == "gbdt" and info["num_trees"] == "4"


@pytest.mark.parametrize("reg", [False, True], ids=["gini", "variance"])
def test_decision_tree_ops_match_jax(jax_default_1dev, reg):
    """DecisionTree(Reg)TrainBatchOp in both packages on the same table:
    the same splits and thresholds, leaf values within rtol 1e-4, and the
    predict ops' labels (or values, within rtol 1e-4) alike."""
    from alink_tpu.operator.batch.classification.tree_ops import (
        DecisionTreePredictBatchOp as JPredict,
        DecisionTreeRegTrainBatchOp as JReg,
        DecisionTreeTrainBatchOp as JCls, TreeModelDataConverter as JConv)
    from alink_tpu.operator.batch.source import MemSourceBatchOp
    X, _ = _gbdt_fixture(n=800, F=3, seed=13)
    y = (X[:, 0] * 2 + X[:, 1] if reg
         else np.where(X[:, 0] > 0.2, "hi", np.where(X[:, 2] > 0, "mid",
                                                        "lo")))
    rows = [tuple(map(float, x)) + ((float(t),) if reg else (str(t),))
            for x, t in zip(X, y)]
    schema = "a DOUBLE, b DOUBLE, c DOUBLE, y " + ("DOUBLE" if reg
                                                  else "STRING")
    kw = dict(feature_cols=["a", "b", "c"], label_col="y", max_depth=4)
    jcls, tcls = ((JReg, tops.DecisionTreeRegTrainBatchOp) if reg
                  else (JCls, tops.DecisionTreeTrainBatchOp))
    jop = jcls(**kw).link_from(MemSourceBatchOp(rows, schema))
    top = tcls(device="cpu", **kw).link_from(TMem(rows, schema))
    jm = JConv().load_model(jop.get_output_table())
    tm = tops.TreeModelDataConverter().load_model(top.get_output_table())
    assert (tm.features >= 0).sum() >= 5
    for k in ("features", "thresholds", "split_masks"):
        assert np.array_equal(getattr(jm, k), getattr(tm, k)), k
    _close(jm.leaf_values, tm.leaf_values, "leaf values")
    assert jm.labels == tm.labels
    jout = JPredict(prediction_col="p").link_from(
        jop, MemSourceBatchOp(rows, schema)).get_output_table()
    tout = tops.DecisionTreePredictBatchOp(prediction_col="p").link_from(
        top, TMem(rows, schema)).get_output_table()
    if reg:
        _close(jout.col("p"), tout.col("p"), "predictions")
    else:
        assert list(jout.col("p")) == list(tout.col("p"))


def test_tree_model_from_numpy_serves_a_jax_run(jenv):
    """A JAX ``gbdt_train`` run carried across as numpy arrays is served
    by the port exactly as the JAX package's op would store it."""
    from alink_tpu.operator.common.tree.hist import bins_to_thresholds
    from alink_tpu.operator.common.tree.trainers import (
        TreeTrainParams as JP, gbdt_train as jgbdt)
    X, y = _gbdt_fixture(n=500, F=4, seed=11)
    tf, tb, tm, tv, edges, base, curve, imp = jgbdt(
        X, y, JP(num_trees=2, max_depth=3, n_bins=16), False, env=jenv)
    m = tree_model_from_numpy(
        "gbdt", np.asarray(tf), np.asarray(tb), np.asarray(tv), edges,
        is_regression=False, max_depth=3, labels=[0, 1], base_score=base,
        learning_rate=0.3, split_masks=np.asarray(tm),
        importances=np.asarray(imp), feature_cols=["a", "b", "c", "d"],
        label_type="LONG")
    thr = np.stack([bins_to_thresholds(np.asarray(tf[i]), np.asarray(tb[i]),
                                       edges) for i in range(2)])
    assert np.array_equal(m.thresholds, thr)
    table = tops.TreeModelDataConverter().save_model(m)
    rows = [tuple(map(float, x)) for x in X]
    data = TMTable(rows, "a DOUBLE, b DOUBLE, c DOUBLE, d DOUBLE")
    mp = _mapper(table, data.schema, prediction_col="p")
    got = TPredictor(mp, device="cpu", ship_dtype=torch.float64) \
        .predict_table(data)
    assert list(got.col("p")) == list(mp.map_table(data).col("p"))
    assert np.mean(np.asarray(got.col("p")) == y.astype(int)) > 0.9


# ---------------------------------------------------------------------------
# randomness (random forests) and the quantile pass
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("F,ratio", [(1, 0.7), (6, 0.5), (14, 0.7), (9, 0.1)])
def test_feature_subsample_exact_count(F, ratio):
    gen = torch.Generator().manual_seed(F)
    for _ in range(20):
        mask = ttr._feature_subsample_mask(gen, F, ratio, torch.float32,
                                           torch.device("cpu"))
        assert int(mask.sum()) == max(1, int(round(ratio * F)))


def _rf(tenv, seed, **kw):
    X, y = _gbdt_fixture(n=500, F=6, seed=5)
    stats = np.concatenate([np.eye(2)[y.astype(int)], np.ones((500, 1))], 1)
    p = ttr.TreeTrainParams(num_trees=4, max_depth=3, n_bins=16, seed=seed,
                            subsample_ratio=0.8, feature_subsample_ratio=0.5,
                            **kw)
    return ttr.forest_train(X, stats, p, "gini", env=tenv)


def test_rf_same_seed_same_forest(tenv):
    a, b, c = _rf(tenv, 3), _rf(tenv, 3), _rf(tenv, 4)
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x), np.asarray(y))
    assert not all(np.array_equal(np.asarray(x), np.asarray(y))
                   for x, y in zip(a[:4], c[:4]))
    # each tree splits on at most the 3 features its mask kept
    for tf in a[0]:
        assert len(set(tf[tf >= 0].tolist())) <= 3


def test_rf_bagged_out_rows_have_zero_stats(tenv, monkeypatch):
    seen = []
    real = ttr.build_tree

    def spy(binned, stats, *args, **kw):
        seen.append(stats.clone())
        return real(binned, stats, *args, **kw)
    monkeypatch.setattr(ttr, "build_tree", spy)
    _rf(tenv, 3)
    assert len(seen) == 4
    for st in seen:
        out = (st == 0).all(1)
        inn = (st != 0).any(1)
        assert bool((out | inn).all()) and bool(torch.all(st[inn, -1] == 1))
        assert 0.7 < float(inn.float().mean()) < 0.9
    assert not all(torch.equal(seen[0], s) for s in seen[1:])


def test_distributed_quantiles_matches_jax(jenv, tenv):
    from alink_tpu.operator.common.dataproc.quantile import \
        distributed_quantiles as jq
    from alink_tpu_torch.operator.common.dataproc.quantile import \
        distributed_quantiles as tq
    rng = np.random.RandomState(12)
    X = np.concatenate([rng.randn(3000, 2), rng.randint(0, 12, (3000, 1)),
                        rng.exponential(size=(3000, 1))], 1)
    X[rng.rand(3000) < 0.05, 1] = np.nan
    probs = np.linspace(0, 1, 33)[1:-1]
    a = jq(X, probs, env=jenv, fine_bins=1024)
    b = tq(X, probs, env=tenv, fine_bins=1024)
    assert np.array_equal(a.view(np.int64), b.view(np.int64))
    # and through the device binning path of make_bin_edges
    ea = __import__("alink_tpu.operator.common.tree.hist", fromlist=["x"]) \
        .make_bin_edges(X, 16, device=True, env=jenv)
    eb = thist.make_bin_edges(X, 16, device=True, env=tenv)
    assert np.array_equal(ea, eb)


def test_train_ops_and_predictor_default_to_the_card(monkeypatch, trained):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (tops.GbdtTrainBatchOp, tops.DecisionTreeTrainBatchOp,
                tops.RandomForestRegTrainBatchOp):
        with pytest.raises(RuntimeError, match="CUDA"):
            cls(label_col="label")
    jop, rows, schema = trained["gbdt"]
    data = TMem(rows, schema).get_output_table()
    mp = _mapper(_port_table(jop), data.schema, prediction_col="p")
    with pytest.raises(RuntimeError, match="CUDA"):
        TPredictor(mp)
