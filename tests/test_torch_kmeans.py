"""Slice 13 of the port: KMeans on the CPU against the JAX package.

The same seeded blobs go through ``alink_tpu``'s KMeans (its JAX side on
a 1-device session) and the port's (``device="cpu"``). Tolerances:

* the RANDOM and K_MEANS_PLUS_PLUS initial centroids: bitwise (numpy
  draws, copied);
* the trained centroids after 20 Lloyd iterations at ``tol=0``:
  rtol 1e-12 in float64, rtol 1e-5 in float32, assignments and cluster
  weights equal, EUCLIDEAN and COSINE (measured: bitwise on these
  fixtures);
* K_MEANS_PARALLEL (the default) draws its Gumbel keys from
  ``torch.Generator``s, not JAX's PRNG: every candidate is a row of the
  data, the centroids are the reference's weighted recluster of the
  port's candidates (bitwise), and after training on separated blobs
  the assignments equal the JAX package's up to a permutation of the
  cluster ids, with the inertia within 1e-6 relative;
* ``KMeansPredictBatchOp`` (float64): ids equal; the squared Euclidean
  distances (the cosine ones) within 8 eps (|x| + |c|)^2 (8 eps) of the
  JAX package's, the rounding of the one-product distance, which the
  subtraction near a centroid keeps (measured at most 0.24 of the band
  on the card against the CPU; here 1.8e-14 absolute on the distances).
"""

import jax
import numpy as np
import pytest
import torch

from alink_tpu.common.mlenv import MLEnvironment as JEnv
from alink_tpu.operator.common.clustering import kmeans as jk
from alink_tpu_torch.common.mlenv import MLEnvironment as TEnv
from alink_tpu_torch.common.mtable import MTable as TMTable
from alink_tpu_torch.common.vector import SparseVector as TSparse
from alink_tpu_torch.operator.batch.clustering import (
    KMeansModelDataConverter as TConverter, KMeansPredictBatchOp as TPredict,
    KMeansTrainBatchOp as TTrain)
from alink_tpu_torch.operator.batch.source import MemSourceBatchOp as TMem
from alink_tpu_torch.operator.common.clustering import kmeans as tk

CENTERS = np.asarray([[0.0, 0.0, 0.0], [8.0, 0.0, 1.0], [0.0, 8.0, -1.0],
                      [6.0, 6.0, 6.0]])


@pytest.fixture(scope="module")
def jenv():
    return JEnv(parallelism=1, devices=jax.devices()[:1])


@pytest.fixture(scope="module")
def tenv():
    return TEnv(device="cpu")


@pytest.fixture(scope="module")
def jsid():
    from alink_tpu.common.mlenv import MLEnvironment, MLEnvironmentFactory
    sid = MLEnvironmentFactory.register(
        MLEnvironment(parallelism=1, devices=jax.devices()[:1]))
    yield sid
    MLEnvironmentFactory.remove(sid)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int64) if a.dtype == np.float64 else a.view(np.int32)


def _blobs(dtype=np.float64, n=120, k=3, seed=0, shift=0.0):
    """k well separated blobs (shifted off the origin for COSINE, so that
    their directions differ too)."""
    rng = np.random.RandomState(seed)
    X = np.concatenate([rng.randn(n, 3) + c for c in CENTERS[:k]]) + shift
    return X[rng.permutation(len(X))].astype(dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_host_inits_are_the_jax_packages(dtype):
    X = _blobs(dtype, n=2000)            # past k-means++'s 4096-row cap
    for seed in (0, 3):
        np.testing.assert_array_equal(_bits(tk.random_init(X, 4, seed)),
                                      _bits(jk.random_init(X, 4, seed)))
        np.testing.assert_array_equal(
            _bits(tk.kmeans_plus_plus_init(X, 4, seed)),
            _bits(jk.kmeans_plus_plus_init(X, 4, seed)))


@pytest.mark.parametrize("dist", ["EUCLIDEAN", "COSINE"])
@pytest.mark.parametrize("init", ["RANDOM", "K_MEANS_PLUS_PLUS"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_lloyd_matches_the_jax_package(dtype, init, dist, jenv, tenv):
    X = _blobs(dtype, shift=3.0 if dist == "COSINE" else 0.0)
    kw = dict(max_iter=20, tol=0.0, init=init, distance_type=dist, seed=1)
    jc, jw, js = jk.kmeans_train(X, 3, env=jenv, **kw)
    tc, tw, ts = tk.kmeans_train(X, 3, env=tenv, **kw)
    jc = np.asarray(jc)
    assert js == ts == 20 and tc.dtype == dtype
    np.testing.assert_allclose(tc, jc, rtol=1e-12 if dtype == np.float64
                               else 1e-5)
    np.testing.assert_array_equal(tw, np.asarray(jw))
    tid, _ = tk.assign_clusters(torch.from_numpy(X), torch.tensor(tc),
                                dist)
    jid, _ = jk.assign_clusters(X, jc, dist)
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))


def test_weighted_lloyd_and_its_stop(jenv, tenv):
    """Sample weights, and the stop at ``tol``: the same superstep."""
    X = _blobs()
    w = np.random.RandomState(4).rand(len(X)) * 2
    kw = dict(max_iter=50, tol=1e-6, init="RANDOM", seed=2, sample_weight=w)
    jc, jw, js = jk.kmeans_train(X, 3, env=jenv, **kw)
    tc, tw, ts = tk.kmeans_train(X, 3, env=tenv, **kw)
    assert 1 < ts == js < 50
    np.testing.assert_allclose(tc, np.asarray(jc), rtol=1e-12)
    np.testing.assert_allclose(tw, np.asarray(jw), rtol=1e-12)


def test_probe_series_match_the_reference(jenv, tenv):
    """The Lloyd loop's probes (inertia, movement, empty_clusters): the
    JAX package's series within float32 rounding."""
    X = _blobs()
    got = {}
    for name, mod, env in (("jax", jk, jenv), ("torch", tk, tenv)):
        res = {}
        orig = mod.IterativeComQueue.exec

        def spy(self, _orig=orig, _res=res):
            r = _orig(self)
            _res["r"] = r
            return r
        mod.IterativeComQueue.exec = spy
        try:
            mod.kmeans_train(X, 3, max_iter=6, tol=0.0, init="RANDOM",
                             seed=0, env=env)
        finally:
            mod.IterativeComQueue.exec = orig
        got[name] = res["r"].probes()
    assert sorted(got["torch"]) == sorted(got["jax"]) == [
        "empty_clusters", "inertia", "movement"]
    for k, j in got["jax"].items():
        np.testing.assert_allclose(got["torch"][k], j, rtol=2 ** -22)


def test_kmeans_parallel_init_by_its_properties(jenv, tenv):
    X = _blobs(n=200, k=4)
    cands, weights, rng = tk.parallel_candidates(X, 4, seed=5, env=tenv)
    assert cands.shape == (1 + 5 * 8, 3)
    rows = {tuple(r) for r in X}
    assert all(tuple(c) in rows for c in cands)       # every one a data row
    # the weights count the rows nearest to each candidate (the last
    # round's candidates none yet)
    assert weights.sum() == len(X) and (weights[-8:] == 0).all()
    ref_rng = np.random.RandomState(5)
    ref_rng.randint(len(X))                           # the first row's draw
    w = weights.copy()
    w[w == 0] = 1.0
    want = jk._weighted_kmeans_pp(cands, w, 4, ref_rng)
    got = tk.kmeans_parallel_init(X, 4, seed=5, env=tenv)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    again = tk.kmeans_parallel_init(X, 4, seed=5, env=tenv)
    np.testing.assert_array_equal(_bits(again), _bits(got))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_kmeans_parallel_trains_to_the_same_clusters(dtype, jenv, tenv):
    X = _blobs(dtype, n=200, k=4)
    kw = dict(max_iter=30, tol=1e-6, seed=0)          # K_MEANS_PARALLEL
    jc, _, _ = jk.kmeans_train(X, 4, env=jenv, **kw)
    tc, _, _ = tk.kmeans_train(X, 4, env=tenv, **kw)
    jid, jd = jk.assign_clusters(X, np.asarray(jc), "EUCLIDEAN")
    tid, td = tk.assign_clusters(torch.from_numpy(X), torch.tensor(tc),
                                 "EUCLIDEAN")
    jid, tid = np.asarray(jid), tid.numpy()
    perm = {int(a): int(b) for a, b in zip(tid, jid)}
    assert len(set(perm.values())) == 4
    np.testing.assert_array_equal(np.vectorize(perm.get)(tid), jid)
    inertia_j, inertia_t = float(np.asarray(jd).sum()), float(td.sum())
    assert abs(inertia_t - inertia_j) <= 1e-6 * inertia_j


def _tables(layout, seed=0):
    from alink_tpu.common.mtable import MTable as JMTable
    from alink_tpu.common.vector import SparseVector as JSparse
    X = _blobs(seed=seed)
    out = []
    for MT, SV in ((JMTable, JSparse), (TMTable, TSparse)):
        if layout == "dense":
            out.append(MT({f"x{j}": X[:, j] for j in range(3)},
                          "x0 DOUBLE, x1 DOUBLE, x2 DOUBLE"))
        else:
            col = np.empty(len(X), object)
            col[:] = [SV(3, np.flatnonzero(r), r[r != 0]) for r in X]
            out.append(MT({"vec": col}, "vec VECTOR"))
    return out


def _params(layout, **more):
    p = dict(k=3, max_iter=20, epsilon=0.0, init_mode="RANDOM", seed=1,
             **more)
    if layout == "dense":
        p["feature_cols"] = ["x0", "x1", "x2"]
    else:
        p["vector_col"] = "vec"
    return p


def _train(layout, jsid, **more):
    from alink_tpu.operator.batch.clustering import \
        KMeansTrainBatchOp as JTrain
    from alink_tpu.operator.batch.source.sources import \
        MemSourceBatchOp as JMem
    jt, tt = _tables(layout)
    p = _params(layout, **more)
    jop = JTrain(ml_environment_id=jsid, **p).link_from(
        JMem(jt, ml_environment_id=jsid))
    top = TTrain(device="cpu", dtype=torch.float64, **p).link_from(TMem(tt))
    return jt, tt, jop, top


@pytest.mark.parametrize("dist", ["EUCLIDEAN", "COSINE"])
@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_model_tables_load_in_both_packages(layout, dist, jsid):
    from alink_tpu.common.mtable import MTable as JMTable
    from alink_tpu.common.types import TableSchema as JSchema
    from alink_tpu.operator.batch.clustering.kmeans_ops import \
        KMeansModelDataConverter as JConverter
    _, _, jop, top = _train(layout, jsid, distance_type=dist)
    tmodel, jmodel = top.get_output_table(), jop.get_output_table()
    tm = TConverter().load_model(tmodel)
    jm = JConverter().load_model(jmodel)
    np.testing.assert_allclose(tm.centroids, jm.centroids, rtol=1e-12)
    np.testing.assert_array_equal(tm.weights, jm.weights)
    assert (tm.distance_type, tm.vector_col, tm.feature_cols) == \
        (jm.distance_type, jm.vector_col, jm.feature_cols)
    across = JConverter().load_model(JMTable(tmodel.to_rows(), JSchema(
        list(tmodel.schema.names), list(tmodel.schema.types))))
    np.testing.assert_array_equal(across.centroids, tm.centroids)
    back = TConverter().load_model(TMTable(jmodel.to_rows(),
                                           tmodel.schema))
    np.testing.assert_array_equal(back.centroids, jm.centroids)
    side = top.get_side_output(0).get_output_table()
    assert list(side.col("cluster_id")) == [0, 1, 2]


@pytest.mark.parametrize("dist", ["EUCLIDEAN", "COSINE"])
@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_predict_op_matches_the_jax_package(layout, dist, jsid):
    from alink_tpu.operator.batch.clustering import \
        KMeansPredictBatchOp as JPredict
    from alink_tpu.operator.batch.source.sources import \
        MemSourceBatchOp as JMem
    jt, tt, jop, top = _train(layout, jsid, distance_type=dist)
    pp = dict(prediction_col="cid", prediction_distance_col="dist")
    jout = JPredict(ml_environment_id=jsid, **pp).link_from(
        jop, JMem(jt, ml_environment_id=jsid)).get_output_table()
    tout = TPredict(device="cpu", **pp).link_from(
        top, TMem(tt)).get_output_table()
    assert list(tout.schema.names) == list(jout.schema.names)
    assert list(tout.schema.types) == list(jout.schema.types)
    np.testing.assert_array_equal(np.asarray(tout.col("cid")),
                                  np.asarray(jout.col("cid")))
    # sqrt(x2 - 2 x.c + c2): the square carries the products' rounding,
    # eps (|x| + |c|)^2, which the subtraction near a centroid does not
    # shrink
    X = _blobs()
    C = TConverter().load_model(top.get_output_table()).centroids
    C = C[np.asarray(tout.col("cid"))]
    td, jd = (np.asarray(t.col("dist"), float) for t in (tout, jout))
    if dist == "EUCLIDEAN":
        td, jd = td ** 2, jd ** 2
        scale = (np.sqrt((X ** 2).sum(1)) + np.sqrt((C ** 2).sum(1))) ** 2
    else:
        scale = 1.0
    assert (np.abs(td - jd) <= 8 * np.finfo(np.float64).eps * scale).all()


def test_pipeline_round_trip(jsid):
    import os
    import tempfile
    from alink_tpu_torch.pipeline import Pipeline, PipelineModel
    from alink_tpu_torch.pipeline.clustering import KMeans
    _, tt, _, top = _train("dense", jsid)
    p = dict(_params("dense"), prediction_col="cid")
    want = TPredict(device="cpu", prediction_col="cid").link_from(
        TTrain(device="cpu", **_params("dense")).link_from(TMem(tt)),
        TMem(tt)).get_output_table()
    for model in (KMeans(device="cpu", **p).fit(TMem(tt)),
                  Pipeline(KMeans(**p), device="cpu").fit(TMem(tt))):
        out = model.transform(TMem(tt)).get_output_table()
        assert list(out.col("cid")) == list(want.col("cid"))
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "km.json")
        model.save(path)
        loaded = PipelineModel.load(path)
    loaded.transformers[0].device = "cpu"   # the device is not saved
    out = loaded.transform(TMem(tt)).get_output_table()
    assert list(out.col("cid")) == list(want.col("cid"))
    single = KMeans(device="cpu", **p).fit(TMem(tt)).get_local_predictor()
    assert single.predict(tt).col("cid").tolist() == \
        list(want.col("cid"))


def test_kmeans_defaults_to_the_card(monkeypatch):
    from alink_tpu_torch.pipeline.clustering import KMeans
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tt = _tables("dense")
    for make in (lambda: TTrain(k=2), lambda: TPredict(),
                 lambda: KMeans(k=2, feature_cols=["x0"]).fit(TMem(tt))):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    with pytest.raises(ValueError, match="dtype"):
        TTrain(device="cpu", dtype=torch.float16)
    assert TTrain(device="cpu").dtype == torch.float32


def test_left_out_options_raise(tenv, tmp_path):
    """A resume request without a checkpoint directory is refused
    (checkpoints are ported: tests/test_torch_recovery.py). The health
    monitor is ported: with or without a checkpoint directory it reads
    the Lloyd loop's probes and changes no bit of the centroids
    (tests/test_torch_health.py holds it against the JAX package)."""
    from alink_tpu_torch.common.health import HealthMonitor
    X = _blobs()
    bare = tk.kmeans_train(X, 3, env=tenv)
    for kw in ({}, {"checkpoint_dir": str(tmp_path / "ck")}):
        mon = HealthMonitor()
        got = tk.kmeans_train(X, 3, env=tenv, health=mon, **kw)
        assert all(np.array_equal(a, b) for a, b in zip(got[:2], bare[:2]))
        assert mon.series_names() == ["empty_clusters", "inertia",
                                      "movement"]
    with pytest.raises(ValueError, match="requires checkpoint_dir"):
        tk.kmeans_train(X, 3, env=tenv, resume_from="/x")
