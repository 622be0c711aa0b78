"""Slice 1 of the port as a whole: a linear model built by the JAX
package, carried across, and served by ``alink_tpu_torch`` on the CPU.

The port's ``CompiledPredictor.predict_table`` is held against the JAX
package's ``CompiledPredictor`` (fused kernel on, interpret mode) and
its host ``LinearModelMapper.map_table``: labels exact, scores bitwise.
The port ships float64 here, as the JAX package does under x64.
"""

import threading

import numpy as np
import pytest
import torch

from alink_tpu_torch.common.mtable import MTable as TMTable
from alink_tpu_torch.common.params import Params as TParams
from alink_tpu_torch.common.vector import DenseVector as TDense
from alink_tpu_torch.common.vector import SparseVector as TSparse
from alink_tpu_torch.model.interop import (linear_model_from_numpy,
                                           model_table_from_reference)
from alink_tpu_torch.operator.common.linear.base import \
    LinearModelDataConverter as TConverter
from alink_tpu_torch.operator.common.linear.mapper import \
    LinearModelMapper as TMapper
from alink_tpu_torch.serving import CompiledPredictor as TPredictor
from alink_tpu_torch.serving import PredictServer as TServer

PARAMS = {"prediction_col": "pred", "vector_col": "vec",
          "prediction_detail_col": "det"}


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int64) if a.dtype == np.float64 else a.view(np.int32)


def _jax_seeded_dense(dim=20, n=40, seed=5):
    """A JAX-package model table from seeded coefficients, saved by its
    ``LinearModelDataConverter``, plus dense requests."""
    from alink_tpu.common.mtable import MTable
    from alink_tpu.common.vector import DenseVector
    from alink_tpu.operator.common.linear.base import (
        LinearModelData, LinearModelDataConverter)
    rng = np.random.RandomState(seed)
    model = LinearModelData(
        model_name="LR model", linear_model_type="LR", has_intercept=True,
        vector_col="vec", feature_names=None, vector_size=dim,
        coef=rng.randn(dim + 1), label_values=[1, 0], label_type="LONG")
    table = LinearModelDataConverter("LONG").save_model(model)
    X = rng.randn(n, dim)
    vecs = np.empty(n, object)
    vecs[:] = [DenseVector(x) for x in X]
    return table, MTable({"vec": vecs}, "vec VECTOR")


def _jax_trained_sparse(seed=3, n=48, dim=256, nnz=9):
    """The sparse fixture of tests/test_kernels.py's fused-kernel case:
    ``LogisticRegressionTrainBatchOp(max_iter=2)`` on hashed rows."""
    from alink_tpu.common.mtable import MTable
    from alink_tpu.common.vector import SparseVector
    from alink_tpu.operator.batch.classification.linear import (
        LogisticRegressionTrainBatchOp)
    from alink_tpu.operator.batch.source.sources import MemSourceBatchOp
    rng = np.random.RandomState(seed)
    rows = np.empty(n, object)
    rows[:] = [SparseVector(dim, np.sort(rng.choice(dim, nnz, False)),
                            rng.randn(nnz)) for _ in range(n)]
    y = np.asarray([1 if sum(v.values) > 0 else 0 for v in rows])
    tbl = MTable({"vec": rows, "label": y}, "vec VECTOR, label LONG")
    warm = LogisticRegressionTrainBatchOp(
        vector_col="vec", label_col="label", max_iter=2).link_from(
        MemSourceBatchOp(tbl))
    return warm.get_output_table(), tbl.select(["vec"])


@pytest.fixture(scope="module")
def dense_case():
    return _jax_seeded_dense()


@pytest.fixture(scope="module")
def sparse_case():
    return _jax_trained_sparse()


def _carry(jax_table):
    """The JAX model table as the port's, through plain rows."""
    return model_table_from_reference(jax_table.to_rows(),
                                      jax_table.schema.types[2])


def _port_requests(jax_req):
    """The same request rows as port vectors."""
    out = []
    for (v,) in jax_req.to_rows():
        if hasattr(v, "indices"):
            out.append((TSparse(v.n, v.indices, v.values),))
        else:
            out.append((TDense(v.data),))
    return TMTable(out, "vec VECTOR")


def _mappers(jax_table, jax_req):
    from alink_tpu.common.params import Params
    from alink_tpu.operator.common.linear.mapper import LinearModelMapper
    jm = LinearModelMapper(jax_table.schema, jax_req.schema, Params(PARAMS))
    jm.load_model(jax_table)
    ptable = _carry(jax_table)
    req = _port_requests(jax_req)
    pm = TMapper(ptable.schema, req.schema, TParams(PARAMS))
    pm.load_model(ptable)
    return jm, pm, req


def _jax_scores(pred, req, bucket):
    import jax
    import jax.numpy as jnp
    kern = pred._active.kernel
    kind, arrs = kern.encode(req, bucket)
    out = jax.jit(kern.device_fns[kind])(
        tuple(jnp.asarray(a) for a in kern.model_arrays), *arrs)
    return np.asarray(out)[:req.num_rows]


def _cells(table, col):
    return [str(v) for v in table.col(col)]


def _details(table):
    import json
    return np.asarray([list(json.loads(str(d)).values())
                       for d in table.col("det")])


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("case,buckets,sizes", [
    ("dense", (1, 4, 16), (1, 3, 13, 40)),
    ("sparse", (16, 64), (5, 48))])
def test_predict_table_matches_jax(monkeypatch, request, dtype, case,
                                   buckets, sizes):
    from alink_tpu.serving import CompiledPredictor
    jax_table, jax_req = request.getfixturevalue(f"{case}_case")
    monkeypatch.setenv("ALINK_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("ALINK_TPU_SERVE_FUSED", "1")
    monkeypatch.setenv("ALINK_TPU_SERVE_DTYPE", dtype)
    jm, pm, req = _mappers(jax_table, jax_req)
    jpred = CompiledPredictor(jm, buckets=buckets)
    ppred = TPredictor(pm, buckets=buckets, device="cpu",
                       ship_dtype=torch.float64)
    assert ppred._active.kernel.signature[-1] == dtype
    for k in sizes:
        jsub, psub = jax_req.first_n(k), req.first_n(k)
        got, want = ppred.predict_table(psub), jpred.predict_table(jsub)
        assert _cells(got, "pred") == _cells(want, "pred")
        assert _cells(got, "det") == _cells(want, "det")
        if k <= buckets[-1]:
            scores = ppred.predict_scores(psub)
            ref = _jax_scores(jpred, jsub, jpred.bucket_for(k))
            assert scores.dtype == ref.dtype
            assert np.array_equal(_bits(scores), _bits(ref))
    if dtype == "f32":
        # the host mapper: labels exact on every row
        got = ppred.predict_table(req)
        assert _cells(got, "pred") == _cells(jm.map_table(jax_req), "pred")
        assert _cells(pm.map_table(req), "pred") == _cells(got, "pred")


def test_swap_model_flips_to_the_new_model(dense_case):
    jax_a, jax_req = dense_case
    jax_b = _jax_seeded_dense(seed=11)[0]
    jm_b, pm_b, req = _mappers(jax_b, jax_req)
    _, pm_a, _ = _mappers(jax_a, jax_req)
    pred = TPredictor(pm_a, buckets=(1, 4, 16), device="cpu",
                      ship_dtype=torch.float64)
    before = pred.predict_scores(req)
    assert pred.swap_model(_carry(jax_b)) == 2 and pred.model_version == 2
    after = pred.predict_scores(req)
    fresh = TPredictor(pm_b, buckets=(1, 4, 16), device="cpu",
                       ship_dtype=torch.float64)
    assert np.array_equal(_bits(after), _bits(fresh.predict_scores(req)))
    assert not np.array_equal(before, after)
    assert _cells(pred.predict_table(req), "pred") == \
        _cells(jm_b.map_table(jax_req), "pred")


def test_predict_server_answers_like_predict_table(sparse_case):
    jax_table, jax_req = sparse_case
    _, pm, req = _mappers(jax_table, jax_req)
    pred = TPredictor(pm, buckets=(1, 8, 32), device="cpu",
                      ship_dtype=torch.float64)
    want = pred.predict_table(req)
    rows = req.to_rows()
    answers = {}

    def client(lo, hi):
        futs = [(i, srv.submit(rows[i])) for i in range(lo, hi)]
        for i, f in futs:
            answers[i] = f.result(30)

    with TServer(pred, min_fill=4, window_s=0.005) as srv:
        threads = [threading.Thread(target=client, args=(i, i + 12))
                   for i in range(0, 48, 12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
        assert srv.predict(rows[0], timeout=30) == want.row(0)
    assert len(answers) == 48
    for i, got in answers.items():
        assert [str(v) for v in got] == [str(v) for v in want.row(i)]
    assert pred.predict_row(rows[3]) == want.row(3)
    with pytest.raises(RuntimeError):
        srv.submit(rows[0])


def test_softmax_serves_on_the_host_only():
    """A Softmax model (k = 3) serves through the port's kernels (one
    launch for each non-pivot class column): dense and sparse requests,
    several buckets. Its scores are the JAX package's Softmax serving
    program's (each column a left-to-right sum) within 1.1 eps
    sum|terms|, keep their bits in every bucket, its labels equal
    ``map_table``'s and its details lie within rtol 1e-12 of them; the
    port's ``map_table`` equals the JAX package's."""
    from alink_tpu.common.mtable import MTable
    from alink_tpu.common.params import Params
    from alink_tpu.common.vector import DenseVector, SparseVector
    from alink_tpu.operator.common.linear.base import (
        LinearModelData, LinearModelDataConverter)
    from alink_tpu.operator.common.linear.mapper import LinearModelMapper
    from alink_tpu.serving import CompiledPredictor
    rng = np.random.RandomState(2)
    dim, k = 6, 3
    model = LinearModelData(
        model_name="softmax", linear_model_type="Softmax",
        has_intercept=True, vector_col="vec", feature_names=None,
        vector_size=dim, coef=rng.randn((k - 1) * (dim + 1)),
        label_values=["a", "b", "c"], label_type="STRING")
    table = LinearModelDataConverter("STRING").save_model(model)
    dense = np.empty(9, object)
    dense[:] = [DenseVector(x) for x in rng.randn(9, dim)]
    sparse = np.empty(9, object)
    sparse[:] = [SparseVector(dim, np.sort(rng.choice(dim, 3, False)),
                              rng.randn(3)) for _ in range(9)]
    for vecs in (dense, sparse):
        jax_req = MTable({"vec": vecs}, "vec VECTOR")
        jm = LinearModelMapper(table.schema, jax_req.schema, Params(PARAMS))
        jm.load_model(table)
        _, pm, req = _mappers(table, jax_req)
        want = jm.map_table(jax_req)
        got = pm.map_table(req)
        assert _cells(got, "pred") == _cells(want, "pred")
        assert _cells(got, "det") == _cells(want, "det")
        # the served scores sum in the kernels' order, map_table's in
        # numpy's: the labels are equal, the details within rtol 1e-12
        ppred = TPredictor(pm, buckets=(1, 4, 16), device="cpu",
                           ship_dtype=torch.float64)
        served = ppred.predict_table(req)
        assert _cells(served, "pred") == _cells(want, "pred")
        np.testing.assert_allclose(_details(served), _details(want),
                                   rtol=1e-12)
        jpred = CompiledPredictor(jm, buckets=(16,))
        scores = ppred.predict_scores(req)
        assert scores.shape == (9, k - 1)
        # XLA's CPU backend contracts this short chain's multiplies into
        # its adds (ROADMAP Queue C, slice 1); the kernels do not
        W = model.coef.reshape(k - 1, dim + 1)
        X = np.stack([v.to_dense().data if hasattr(v, "indices") else v.data
                      for v in vecs])
        terms = np.abs(X) @ np.abs(W[:, 1:]).T + np.abs(W[:, 0])
        gap = np.abs(scores - _jax_scores(jpred, jax_req, 16))
        assert (gap <= 1.1 * np.finfo(np.float64).eps * terms).all()
        for n in (1, 3):        # the bucket does not move a row's bits
            np.testing.assert_array_equal(
                _bits(ppred.predict_scores(req.take_rows(np.arange(n)))),
                _bits(scores[:n]))


def test_model_tables_load_in_both_packages():
    """A model table saved by either package loads in the other, field
    for field."""
    from alink_tpu.common.mtable import MTable
    from alink_tpu.operator.common.linear.base import LinearModelDataConverter
    rng = np.random.RandomState(9)
    coef = rng.randn(33)
    mine = linear_model_from_numpy(coef, has_intercept=True,
                                   label_values=["yes", "no"],
                                   vector_col="vec", vector_size=32)
    saved = TConverter("STRING").save_model(mine)
    theirs = LinearModelDataConverter.load_table(
        MTable(saved.to_rows(), saved.schema.to_spec()))
    back = TConverter.load_table(_carry(
        LinearModelDataConverter("STRING").save_model(theirs)))
    for m in (theirs, back):
        assert np.array_equal(m.coef, coef)
        assert (m.linear_model_type, m.has_intercept, m.vector_col,
                m.vector_size, list(m.label_values)) == \
            ("LR", True, "vec", 32, ["yes", "no"])


@pytest.mark.parametrize("name,raws", [
    ("ALINK_TPU_SERVE_BUCKETS", ["", "4,1, 16", "0,-2", "8"]),
    ("ALINK_TPU_SERVE_DTYPE", ["", "bf16", "BFLOAT16", "i8", "fp32", "0"]),
    ("ALINK_TPU_SERVE_WINDOW_MS", ["", "3.5", "-1"]),
    ("ALINK_TPU_SERVE_MIN_FILL", ["", "4", "0"]),
    ("ALINK_TPU_SERVE_QUEUE", ["", "16", "-5"])])
def test_serving_flags_parse_like_the_jax_package(monkeypatch, name, raws):
    from alink_tpu.common.flags import flag_value as jax_flag
    from alink_tpu.serving.predictor import serve_buckets as jax_buckets
    from alink_tpu_torch.common.flags import flag_value
    from alink_tpu_torch.serving.predictor import serve_buckets
    for raw in raws:
        monkeypatch.setenv(name, raw)
        assert flag_value(name) == jax_flag(name), raw
        assert serve_buckets() == jax_buckets(), raw
    monkeypatch.setenv("ALINK_TPU_SERVE_DTYPE", "int4")
    with pytest.raises(ValueError):
        flag_value("ALINK_TPU_SERVE_DTYPE")
