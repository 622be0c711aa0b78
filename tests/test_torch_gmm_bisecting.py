"""Slice 23 of the port: GMM and bisecting KMeans on the CPU against the
JAX package.

The JAX side runs under x64 on a 1-device default session, the port with
``device="cpu"`` and ``dtype=torch.float64``. Tolerances:

* ``gmm_train`` over 10 EM iterations at ``tol=0``, and run to its stop
  at ``tol=1e-6``: equal step counts first, then the weights, means,
  covariances and mean log-likelihood within rtol 1e-10 (the log
  densities are one product a component here, one einsum there);
* ``GmmPredictBatchOp``: ids equal, the detail probabilities within
  rtol 1e-10;
* ``BisectingKMeansTrainBatchOp`` on separated blobs: each split's
  k-means|| draws its keys from ``torch.Generator``s, not JAX's PRNG
  (``tests/test_torch_kmeans.py``), so the two packages may number a
  split's halves the other way round; up to that permutation of the ids
  the centroids agree within rtol 1e-12, the weights and the
  assignments equal. With ``init_mode="RANDOM"`` (host draws) the port's
  split is the same on every device: two runs bitwise;
* ``_assign_np``: the JAX package's, ties to the first index;
* each package's GMM table predicts the same in the other; the pipeline
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
from alink_tpu.operator.batch.clustering import gmm_bisecting as jg
from alink_tpu.operator.batch.clustering.kmeans_ops import \
    KMeansModelDataConverter as JKConv
from alink_tpu.operator.batch.source import MemSourceBatchOp as JMem
from alink_tpu_torch.common.mlenv import MLEnvironment as TEnv
from alink_tpu_torch.model.interop import simple_model_table_from_reference
from alink_tpu_torch.operator.batch.clustering import gmm_bisecting as tg
from alink_tpu_torch.operator.batch.clustering.kmeans_ops import \
    KMeansModelDataConverter as TKConv
from alink_tpu_torch.operator.batch.source import MemSourceBatchOp as TMem
from alink_tpu_torch.pipeline import BisectingKMeans, GaussianMixture

RTOL = 1e-10
SCHEMA = "a DOUBLE, b DOUBLE, c DOUBLE"
OUT = dict(prediction_col="cid", prediction_detail_col="detail")


@pytest.fixture
def jax_default_1dev():
    prev = JFactory.get_default()
    JFactory.set_default(JEnv(parallelism=1, devices=jax.devices()[:1]))
    yield
    JFactory.set_default(prev)


def _blobs(n=120, seed=1):
    """Three anisotropic, partly overlapping blobs in 3 columns."""
    rng = np.random.RandomState(seed)
    X = np.vstack([rng.randn(n, 3) * [0.5, 0.5, 0.3] + [0, 0, 0],
                   rng.randn(n, 3) * [1.5, 0.3, 0.4] + [4, 2, 1],
                   rng.randn(n, 3) * [0.4, 1.2, 0.6] + [1, 5, -1]])
    return X[rng.permutation(len(X))]


def _rows(X):
    return [tuple(map(float, r)) for r in X]


@pytest.mark.parametrize("max_iter,tol", [(10, 0.0), (200, 1e-6)])
def test_em_matches_the_jax_package(max_iter, tol, jax_default_1dev):
    X = _blobs()
    tw, tmu, tcov, tll, ts = tg.gmm_train(X, 3, max_iter, tol, seed=2,
                                          env=TEnv(device="cpu"))
    jw, jmu, jcov, jll, js = jg.gmm_train(X, 3, max_iter, tol, seed=2)
    assert ts == js, f"the port stopped at {ts}, the JAX package at {js}"
    if tol == 0.0:
        assert ts == max_iter
    else:
        assert 2 < ts < max_iter
    for a, b in ((tw, jw), (tmu, jmu), (tcov, jcov)):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=RTOL,
                                   atol=RTOL * np.abs(b).max())
    np.testing.assert_allclose(tll, jll, rtol=RTOL)


def test_ops_predictions_and_tables_across(jax_default_1dev):
    X = _blobs()
    kw = dict(feature_cols=["a", "b", "c"], k=3, max_iter=50, seed=2)
    top = tg.GmmTrainBatchOp(device="cpu", dtype=torch.float64, **kw) \
        .link_from(TMem(_rows(X), SCHEMA))
    jop = jg.GmmTrainBatchOp(**kw).link_from(JMem(_rows(X), SCHEMA))
    assert top._steps == jop._steps
    held = _rows(_blobs(40, seed=5))
    tout = tg.GmmPredictBatchOp(device="cpu", **OUT).link_from(
        top, TMem(held, SCHEMA)).get_output_table()
    jout = jg.GmmPredictBatchOp(**OUT).link_from(
        jop, JMem(held, SCHEMA)).get_output_table()
    into_port = simple_model_table_from_reference(
        jop.get_output_table().to_rows())
    into_jax = JMTable(top.get_output_table().to_rows(),
                       "model_id LONG, model_info STRING")
    a = tg.GmmPredictBatchOp(device="cpu", **OUT).link_from(
        TMem(into_port), TMem(held, SCHEMA)).get_output_table()
    b = jg.GmmPredictBatchOp(**OUT).link_from(
        JMem(into_jax), JMem(held, SCHEMA)).get_output_table()
    for x, y in ((tout, jout), (a, jout), (b, tout)):
        assert list(x.col("cid")) == list(y.col("cid"))
        for u, v in zip(x.col("detail"), y.col("detail")):
            du, dv = json.loads(u), json.loads(v)
            np.testing.assert_allclose([du[k] for k in dv],
                                       [dv[k] for k in dv], rtol=RTOL,
                                       atol=1e-300)


def test_float32_em_keeps_its_dtype_and_repeats():
    X = _blobs()
    runs = [tg.gmm_train(X, 3, 15, 0.0, seed=2, env=TEnv(device="cpu"),
                         dtype=torch.float32) for _ in range(2)]
    for a, b in zip(runs[0][:3], runs[1][:3]):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    # float32 stays near the float64 run
    w64 = tg.gmm_train(X, 3, 15, 0.0, seed=2, env=TEnv(device="cpu"))[0]
    np.testing.assert_allclose(runs[0][0], w64, rtol=1e-3)


def test_weak_typed_floor_of_an_empty_component():
    """``max(w, 1e-300)`` is 0 in float32 (a weak-typed constant there):
    an empty component's log weight is -inf, as the JAX package's."""
    w = torch.tensor([0.5, 0.0], dtype=torch.float32)
    assert torch.log(tg._floor(w, 1e-300))[1].item() == -np.inf
    assert torch.log(tg._floor(w.double(), 1e-300))[1].item() > -700


def _separated(seed=2):
    rng = np.random.RandomState(seed)
    return np.vstack([rng.randn(60, 2) * 0.3 + c
                      for c in [[0, 0], [4, 4], [0, 6], [8, 0]]])


def _canonical(cents, ids):
    """Centroids sorted by their coordinates, and the ids renamed to
    that order."""
    order = np.lexsort(cents.T[::-1])
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    return cents[order], rank[ids]


def test_bisecting_kmeans_matches_the_jax_package(jax_default_1dev):
    X = _separated()
    rows = [tuple(map(float, r)) for r in X]
    kw = dict(feature_cols=["a", "b"], k=4, seed=1)
    top = tg.BisectingKMeansTrainBatchOp(device="cpu", dtype=torch.float64,
                                         **kw).link_from(TMem(rows, "a DOUBLE, b DOUBLE"))
    jop = jg.BisectingKMeansTrainBatchOp(**kw).link_from(
        JMem(rows, "a DOUBLE, b DOUBLE"))
    tmod = TKConv().load_model(top.get_output_table())
    jmod = JKConv().load_model(jop.get_output_table())
    tout = tg.BisectingKMeansPredictBatchOp(device="cpu", prediction_col="cid") \
        .link_from(top, TMem(rows, "a DOUBLE, b DOUBLE")).get_output_table()
    jout = jg.BisectingKMeansPredictBatchOp(prediction_col="cid").link_from(
        jop, JMem(rows, "a DOUBLE, b DOUBLE")).get_output_table()
    tc, tids = _canonical(tmod.centroids, np.asarray(tout.col("cid")))
    jc, jids = _canonical(jmod.centroids, np.asarray(jout.col("cid")))
    np.testing.assert_allclose(tc, jc, rtol=1e-12)
    np.testing.assert_array_equal(tids, jids)
    for g in range(4):
        assert len(set(tids[g * 60:(g + 1) * 60])) == 1
    np.testing.assert_array_equal(np.sort(tmod.weights), np.sort(jmod.weights))


def test_bisecting_random_init_repeats():
    X = _separated(seed=3)
    rows = [tuple(map(float, r)) for r in X]
    kw = dict(feature_cols=["a", "b"], k=5, seed=4, init_mode="RANDOM")
    a, b = (tg.BisectingKMeansTrainBatchOp(device="cpu", dtype=torch.float64,
                                           **kw)
            .link_from(TMem(rows, "a DOUBLE, b DOUBLE")).get_output_table()
            for _ in range(2))
    assert a.to_rows() == b.to_rows()
    assert TKConv().load_model(a).k == 5


def test_assign_ties_go_to_the_first_index():
    X = np.asarray([[0.0, 0.0], [1.0, 0.0], [2.0, 0.0], [0.5, 0.0]])
    C = np.asarray([[0.5, 0.0], [1.5, 0.0], [0.5, 0.0]])
    ti, td = tg._assign_np(X, C)
    ji, jd = jg._assign_np(X, C)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td, jd)
    assert ti.tolist() == [0, 0, 1, 0]


def test_pipeline_stages_fit_and_transform():
    X = _blobs()
    rows = _rows(X)
    kw = dict(feature_cols=["a", "b", "c"], k=3, max_iter=30, seed=2)
    model = GaussianMixture(device="cpu", dtype=torch.float64,
                            prediction_col="cid", **kw).fit(TMem(rows, SCHEMA))
    got = model.transform(TMem(rows, SCHEMA)).get_output_table()
    op = tg.GmmTrainBatchOp(device="cpu", dtype=torch.float64, **kw) \
        .link_from(TMem(rows, SCHEMA))
    want = tg.GmmPredictBatchOp(device="cpu", prediction_col="cid") \
        .link_from(op, TMem(rows, SCHEMA)).get_output_table()
    assert got.to_rows() == want.to_rows()
    bk = BisectingKMeans(device="cpu", dtype=torch.float64, k=3,
                         feature_cols=["a", "b", "c"], init_mode="RANDOM",
                         prediction_col="cid").fit(TMem(rows, SCHEMA))
    out = bk.transform(TMem(rows, SCHEMA)).get_output_table()
    assert sorted(set(out.col("cid"))) == [0, 1, 2]
