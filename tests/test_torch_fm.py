"""Slice 18 of the port: factorization machines on the CPU against the JAX
package.

The same seeded rows (numpy) go through ``alink_tpu``'s FM (its JAX side
on a 1-device session, float64 under the tests' x64) and the port's
(``device="cpu"``, ``dtype=torch.float64``). Tolerances:

* ``fm_train`` at ``batches_per_epoch=1`` (the mask all ones in both
  packages): rtol 1e-10 of the largest value on ``w0``, ``w``, ``V`` and
  the loss curve, dense and padded-COO (measured about 5e-16: the sums
  differ in association only; the COO gradient's scatter is bitwise);
* at 8 mini-batches the port draws its masks from ``torch.Generator``s:
  held by its properties (finite, the loss falls, two runs bitwise, a
  separable fixture learned) and the JAX package's loss range over 5
  seeds widened by 3x its spread;
* the FM score kernel's plain version ("P4", ``kernels/fm.py``) against
  the JAX package's ``serving_kernel`` ``device_fns`` under x64, sparse
  and dense at every default bucket: bitwise against the functions run
  op by op (``scan_sum``'s order, one rounded op at a time, the
  contract); against the jitted program within ``FM_JIT_GAP`` eps of the
  terms' magnitude (``|w0| + sum|x w| + 0.5 sum_f ((sum|x||V|)^2 + q)``),
  XLA's fusion contracting and reordering the products inside the scan
  (measured at most 0.38, and bitwise at one row); and bitwise at the
  kernel's edges (k 1 and 33, a dense model of 997 features served at
  1000, sparse rows 256 wide with repeated indices and an all-padding
  row);
* ``CompiledPredictor`` (float64 ship) labels equal to ``map_table``'s
  outside a 1e-9 band of the margin, the JAX package's served margins
  bitwise;
* the model table both ways between the packages, the twin row for row
  against the batch op (also through the compiled route), the pipeline
  stages and ``OneVsRest``.
"""

import jax
import numpy as np
import pytest
import torch

from alink_tpu.common.mlenv import MLEnvironment as JEnv
from alink_tpu.common.mtable import MTable as JMTable
from alink_tpu.common.params import Params as JParams
from alink_tpu.common.types import TableSchema as JSchema
from alink_tpu.operator.batch.classification import fm_ops as jops
from alink_tpu.operator.common.fm import fm as jfm
from alink_tpu_torch.common.mlenv import MLEnvironment as TEnv
from alink_tpu_torch.common.mtable import MTable as TMTable
from alink_tpu_torch.common.params import Params as TParams
from alink_tpu_torch.common.vector import SparseVector as TSparse
from alink_tpu_torch.kernels import fm as kfm
from alink_tpu_torch.model import interop
from alink_tpu_torch.operator.batch.classification import fm_ops as tops
from alink_tpu_torch.operator.batch.source import MemSourceBatchOp as TMem
from alink_tpu_torch.operator.common.fm import fm as tfm
from alink_tpu_torch.operator.stream import predict_ops as tpo
from alink_tpu_torch.operator.stream.source import \
    MemSourceStreamOp as TMemStream
from alink_tpu_torch.pipeline import fm_nb as tpipe
from alink_tpu_torch.serving import CompiledPredictor

D, NNZ = 24, 5
TRAIN_RTOL = 1e-10
FM_JIT_GAP = 1.0


@pytest.fixture(scope="module")
def jenv():
    return JEnv(parallelism=1, devices=jax.devices()[:1])


@pytest.fixture(scope="module")
def tenv():
    return TEnv(device="cpu")


def _jt(t):
    """The JAX package's table of the port's table's rows."""
    return JMTable(t.to_rows(), JSchema(list(t.schema.names),
                                        list(t.schema.types)))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _data(layout, n=120, seed=0, regression=False):
    rng = np.random.RandomState(seed)
    w_true = rng.randn(D)
    V_true = rng.randn(D, 2) * 0.5
    if layout == "dense":
        X = rng.randn(n, D) * (rng.rand(n, D) < 0.3)
        idx = val = None
    else:
        idx = np.sort(np.stack([rng.choice(D, NNZ, replace=False)
                                for _ in range(n)]), 1).astype(np.int32)
        val = rng.rand(n, NNZ) + 0.5
        idx[::9, -1] = 0                  # padded tail positions
        val[::9, -1] = 0.0
        X = np.zeros((n, D))
        np.add.at(X, (np.arange(n)[:, None], idx), val)
    s = X @ V_true
    margin = X @ w_true + 0.5 * ((s ** 2) - (X ** 2) @ (V_true ** 2)).sum(1)
    y = margin + 0.1 * rng.randn(n) if regression \
        else np.where(margin > np.median(margin), 1.0, -1.0)
    data = {"X": X} if layout == "dense" else {"idx": idx, "val": val}
    data.update(y=y, w=np.ones(n))
    return data, X


@pytest.mark.parametrize("regression", [False, True])
@pytest.mark.parametrize("layout", ["dense", "coo"])
def test_fm_train_one_batch_f64_vs_jax(layout, regression, jenv, tenv):
    data, _ = _data(layout, regression=regression)
    kw = dict(num_factors=3, num_epochs=6, batches_per_epoch=1,
              learn_rate=0.05, lambda_1=1e-3, lambda_2=1e-3,
              is_regression=regression, seed=4)
    got = tfm.fm_train(data, D, tfm.FmTrainParams(**kw), env=tenv)
    want = jfm.fm_train(data, D, jfm.FmTrainParams(**kw), env=jenv)
    for g, w in zip(got[:4], want[:4]):
        assert np.asarray(g).shape == np.asarray(w).shape
        assert _rel(g, w) <= TRAIN_RTOL
    assert got[4] == want[4] == 6
    assert got[3].shape == (6,)


def _curve_auc(w0, w, V, X, y):
    s = X @ V
    m = w0 + X @ w + 0.5 * ((s ** 2) - (X ** 2) @ (V ** 2)).sum(1)
    pos, neg = m[y > 0], m[y < 0]
    return float((pos[:, None] > neg[None, :]).mean())


def test_fm_train_minibatches_by_properties(jenv, tenv):
    data, X = _data("coo", n=200, seed=1)
    kw = dict(num_factors=3, num_epochs=8, batches_per_epoch=8,
              learn_rate=0.1)
    a = tfm.fm_train(data, D, tfm.FmTrainParams(seed=2, **kw), env=tenv)
    b = tfm.fm_train(data, D, tfm.FmTrainParams(seed=2, **kw), env=tenv)
    for u, v in zip(a[:4], b[:4]):
        assert np.array_equal(np.asarray(u), np.asarray(v))
    assert all(np.isfinite(np.asarray(t)).all() for t in a[:4])
    assert a[3][-1] < a[3][0]
    assert _curve_auc(a[0], a[1], a[2], X, data["y"]) > 0.8
    # the final loss inside the JAX package's range over 5 seeds, widened
    # by 3x its spread (the masks come from other generators)
    jl = [jfm.fm_train(data, D, jfm.FmTrainParams(seed=s, **kw),
                       env=jenv)[3][-1] for s in range(5)]
    lo, hi = min(jl), max(jl)
    spread = max(hi - lo, 1e-12)
    assert lo - 3 * spread <= a[3][-1] <= hi + 3 * spread


def _jax_mapper(table, data_schema):
    m = jops.FmModelMapper(table.schema, data_schema,
                           JParams({"prediction_col": "p"}))
    m.load_model(table)
    return m


def _model_table(seed=0, regression=False):
    rng = np.random.RandomState(seed)
    return interop.fm_model_from_numpy(
        0.3, rng.randn(D) * 0.5, rng.randn(D, 4) * 0.5,
        is_regression=regression, label_values=[1, 0], vector_col="vec",
        label_type="LONG")


def _requests(n, seed=1):
    rng = np.random.RandomState(seed)
    rows = []
    for i in range(n):
        k = rng.randint(1, NNZ + 4)
        ix = np.sort(rng.choice(D, k, replace=False))
        rows.append((TSparse(D, ix, rng.randn(k)),))
    return rows


@pytest.mark.parametrize("bucket", [1, 8, 32, 128, 512])
@pytest.mark.parametrize("kind", ["sparse", "dense"])
def test_p4_plain_bitwise_vs_jax_serving_kernel(kind, bucket):
    table = _model_table()
    jt = _jt(table)
    jk = _jax_mapper(jt, None).serving_kernel()
    tm = tops.FmModelMapper(table.schema, None,
                            TParams({"prediction_col": "p"}))
    tm.load_model(table)
    tk = tm.serving_kernel(torch.float64)
    rng = np.random.RandomState(bucket)
    w0, w, V = (t.numpy() for t in tk.model_arrays)
    for j, t in zip(jk.model_arrays, (w0.reshape(()), w, V)):
        assert np.array_equal(np.asarray(j), t)
    if kind == "sparse":
        idx = rng.randint(0, D, (bucket, 16)).astype(np.int32)
        val = rng.randn(bucket, 16)
        val[:, 11:] = 0.0
        idx[:, 11:] = 0
        args = (idx, val)
        got = kfm.fm_scores(tk.model_arrays, torch.from_numpy(idx),
                            torch.from_numpy(val)).numpy()
    else:
        X = rng.randn(bucket, w.shape[0]) * (rng.rand(bucket, w.shape[0])
                                              < 0.5)
        args = (X,)
        got = kfm.fm_scores(tk.model_arrays, None,
                            torch.from_numpy(X)).numpy()
    eager = np.asarray(jk.device_fns[kind](jk.model_arrays, *args))
    assert eager.dtype == got.dtype == np.float64
    assert np.array_equal(eager.view(np.int64), got.view(np.int64))
    jit = np.asarray(jax.jit(jk.device_fns[kind])(jk.model_arrays, *args))
    scale = _fm_scale(jk.model_arrays, idx if kind == "sparse" else None,
                      val if kind == "sparse" else X)
    assert (np.abs(got - jit) <= FM_JIT_GAP * np.finfo(np.float64).eps
            * scale).all()
    if bucket == 1:
        assert np.array_equal(jit.view(np.int64), got.view(np.int64))


# the kernel's edges (its tiling over the factors and the positions): one
# factor and 33 (past a warp), a dense model of 997 features served at
# 1000 (its SERVE_CHUNK multiple), sparse rows 256 wide
P4_EDGE_DENSE_DIM, P4_EDGE_SPARSE_WIDTH = 997, 256


@pytest.mark.parametrize("k", [1, 33])
@pytest.mark.parametrize("kind", ["sparse", "dense"])
def test_p4_plain_bitwise_vs_jax_at_kernel_edges(kind, k):
    """``fm_scores_plain`` (the version the card's kernel is held to)
    bitwise (float64) to the JAX package's ``_dense`` / ``_sparse`` run op
    by op, at the kernel's edges: dense rows of 997 features padded to
    1000; sparse rows 256 wide whose second quarter repeats the first's
    indices, with a padded tail and an all-padding last row."""
    rng = np.random.RandomState(k)
    dim = P4_EDGE_DENSE_DIM if kind == "dense" else 300
    table = interop.fm_model_from_numpy(
        0.2, rng.randn(dim) * 0.3, rng.randn(dim, k) * 0.3,
        is_regression=False, label_values=[1, 0], vector_col="vec",
        label_type="LONG")
    jk = _jax_mapper(_jt(table), None).serving_kernel()
    tm = tops.FmModelMapper(table.schema, None,
                            TParams({"prediction_col": "p"}))
    tm.load_model(table)
    tk = tm.serving_kernel(torch.float64)
    w0, w, V = (t.numpy() for t in tk.model_arrays)
    for j, t in zip(jk.model_arrays, (w0.reshape(()), w, V)):
        assert np.array_equal(np.asarray(j), t)
    n = 5
    if kind == "dense":
        dim8 = w.shape[0]
        assert dim8 == -(-dim // 8) * 8 == 1000
        X = np.zeros((n, dim8))
        X[:, :dim] = rng.randn(n, dim) * (rng.rand(n, dim) < 0.5)
        args = (X,)
        got = kfm.fm_scores(tk.model_arrays, None, torch.from_numpy(X))
    else:
        width = P4_EDGE_SPARSE_WIDTH
        idx = rng.randint(0, dim, (n, width)).astype(np.int32)
        val = rng.randn(n, width)
        idx[:, 64:128] = idx[:, :64]
        idx[:, -32:], val[:, -32:] = 0, 0.0
        idx[-1], val[-1] = 0, 0.0
        args = (idx, val)
        got = kfm.fm_scores(tk.model_arrays, torch.from_numpy(idx),
                            torch.from_numpy(val))
    eager = np.asarray(jk.device_fns[kind](jk.model_arrays, *args))
    got = got.numpy()
    assert eager.dtype == got.dtype == np.float64
    assert np.array_equal(eager.view(np.int64), got.view(np.int64))
    if kind == "sparse":
        assert got[-1] == 0.2            # w0 alone: every term a no-op


def _fm_scale(mdl, idx, val):
    """The magnitude of a row's FM terms: ``|w0| + sum |x w| + 0.5 *
    sum_f ((sum |x| |V|)^2 + q_f)``."""
    w0, w, V = (np.asarray(a, np.float64) for a in mdl)
    if idx is None:
        idx = np.broadcast_to(np.arange(val.shape[1]), val.shape)
    sa = (np.abs(val)[..., None] * np.abs(V[idx])).sum(1)
    q = ((val ** 2)[..., None] * (V ** 2)[idx]).sum(1)
    return (np.abs(w0).reshape(()) + np.abs(val * w[idx]).sum(1)
            + 0.5 * (sa ** 2 + q).sum(1))


def test_p4_padding_is_a_noop_and_cpu_counts_nothing():
    table = _model_table(seed=3)
    tm = tops.FmModelMapper(table.schema, None,
                            TParams({"prediction_col": "p"}))
    tm.load_model(table)
    arrays = tm.serving_kernel(torch.float32).model_arrays
    rng = np.random.RandomState(0)
    idx = torch.from_numpy(rng.randint(0, D, (3, 8)).astype(np.int32))
    val = torch.from_numpy(rng.randn(3, 8).astype(np.float32))
    one = kfm.fm_scores(arrays, idx, val)
    wide_i = torch.zeros((5, 24), dtype=torch.int32)
    wide_v = torch.zeros((5, 24), dtype=torch.float32)
    wide_i[:3, :8], wide_v[:3, :8] = idx, val
    wide = kfm.fm_scores(arrays, wide_i, wide_v)
    assert torch.equal(one.view(torch.int32), wide[:3].view(torch.int32))
    assert kfm.launch_counts() == {"fm_score": 0}


def test_compiled_predictor_labels_and_jax_margins():
    table = _model_table(seed=5)
    rows = _requests(300)
    req = TMTable(rows, "vec VECTOR")
    tm = tops.FmModelMapper(table.schema, req.schema, TParams(
        {"prediction_col": "p", "prediction_detail_col": "d"}))
    tm.load_model(table)
    served = CompiledPredictor(tm, device="cpu", ship_dtype=torch.float64) \
        .predict_table(req)
    host = tm.map_table(req)
    from alink_tpu_torch.operator.common.dataproc.feature_extract import \
        extract_design
    design = extract_design(req, None, "vec", np.float64, vector_size=D)
    m = tm.model
    margin = tfm.fm_predict_margin(m.w0, m.w, m.V, design)
    keep = np.abs(margin) > 1e-9
    assert keep.mean() > 0.9
    assert np.array_equal(np.asarray(served.col("p"))[keep],
                          np.asarray(host.col("p"))[keep])
    # the served margins are the JAX package's serving functions', bitwise
    kind, enc = tm.serving_kernel(torch.float64).encode(req, 512)
    jk = _jax_mapper(_jt(table),
                     None).serving_kernel()
    want = np.asarray(jk.device_fns[kind](
        jk.model_arrays, *(t.numpy() for t in enc)))
    got = kfm.fm_scores(tm.serving_kernel(torch.float64).model_arrays,
                        *enc).numpy()
    assert np.array_equal(want.view(np.int64), got.view(np.int64))


def _train_rows(n=160, seed=0):
    data, X = _data("coo", n=n, seed=seed)
    rows = [(TSparse(D, data["idx"][i][data["val"][i] != 0],
                     data["val"][i][data["val"][i] != 0]),
             int(data["y"][i] > 0)) for i in range(n)]
    return rows, "vec VECTOR, label LONG"


@pytest.mark.parametrize("op_name", ["FmClassifierTrainBatchOp",
                                     "FmRegressorTrainBatchOp"])
def test_train_ops_table_loads_in_jax(op_name):
    rows, schema = _train_rows()
    op = getattr(tops, op_name)(vector_col="vec", label_col="label",
                                num_factor=3, num_epochs=4, device="cpu",
                                dtype=torch.float64).link_from(
        TMem(rows, schema))
    table = op.get_output_table()
    assert op.get_side_output(0).get_output_table().num_rows == 4
    jm = jops.FmModelDataConverter().load_model(
        _jt(table))
    tm = tops.FmModelDataConverter().load_model(table)
    for a, b in ((jm.w, tm.w), (jm.V, tm.V)):
        assert np.array_equal(np.asarray(a).view(np.int64),
                              np.asarray(b).view(np.int64))
    assert jm.w0 == tm.w0 and jm.label_values == tm.label_values
    info = tops.FmModelInfoBatchOp().link_from(op).collect_model_info()
    assert info.get_num_factor() == 3 and info.get_vector_size() == D
    # the port's predict op and the JAX package's give the same rows
    req = TMTable(rows[:50], schema)
    got = tops.FmPredictBatchOp(prediction_col="p").link_from(
        op, TMem(req)).get_output_table()
    from alink_tpu.operator.batch.source import MemSourceBatchOp as JMem
    want = jops.FmPredictBatchOp(prediction_col="p").link_from(
        JMem(_jt(table)),
        JMem(_jt(req))).get_output_table()
    assert [repr(r) for r in got.to_rows()] == [repr(r) for r in
                                                 want.to_rows()]


def test_model_table_interop_both_ways(jenv):
    data, _ = _data("coo", seed=7)
    kw = dict(num_factors=3, num_epochs=3, batches_per_epoch=1)
    w0, w, V, _, _ = jfm.fm_train(data, D, jfm.FmTrainParams(**kw),
                                  env=jenv)
    jtable = jops.FmModelDataConverter().save_model(jops.FmModelData(
        float(w0), np.asarray(w), np.asarray(V), False, "vec", None,
        [1, 0], "LONG"))
    ttable = interop.simple_model_table_from_reference(jtable.to_rows())
    tm = tops.FmModelDataConverter().load_model(ttable)
    assert np.array_equal(tm.V.view(np.int64),
                          np.asarray(V, np.float64).view(np.int64))
    back = interop.fm_model_from_numpy(
        tm.w0, tm.w, tm.V, is_regression=False, label_values=[1, 0],
        vector_col="vec", label_type="LONG")
    jm = jops.FmModelDataConverter().load_model(
        _jt(back))
    assert np.array_equal(np.asarray(jm.w).view(np.int64),
                          np.asarray(w, np.float64).view(np.int64))
    assert back.to_rows() == ttable.to_rows()


@pytest.mark.parametrize("compiled", [False, True])
def test_fm_twin_equals_batch_op(compiled, monkeypatch):
    if compiled:
        monkeypatch.setenv("ALINK_TPU_SERVE_COMPILED", "1")
    table = _model_table(seed=9)
    rows = _requests(150, seed=4)
    batch = tops.FmPredictBatchOp(prediction_col="p").link_from(
        TMem(table), TMem(rows, "vec VECTOR")).get_output_table()
    twin = tpo.FmPredictStreamOp(TMem(table), device="cpu",
                                 prediction_col="p")
    out = []
    for mt in twin.link_from(TMemStream(rows, "vec VECTOR",
                                        batch_size=64)).micro_batches():
        out += mt.to_rows()
    assert (twin._predictor is not None) == compiled
    assert [r[-1] for r in out] == list(batch.col("p"))


def test_pipeline_fm_and_one_vs_rest():
    rows, schema = _train_rows(n=200, seed=2)
    src = TMem(rows, schema)
    for est_cls in (tpipe.FmClassifier, tpipe.FmRegressor):
        model = est_cls(vector_col="vec", label_col="label", num_factor=2,
                        num_epochs=3, prediction_col="p",
                        device="cpu").fit(src)
        out = model.transform(src).get_output_table()
        assert out.num_rows == 200 and "p" in out.col_names
    rng = np.random.RandomState(3)
    three = [(r[0], ["a", "b", "c"][rng.randint(3)]) for r in rows]
    ovr = tpipe.OneVsRest(tpipe.FmClassifier(
        vector_col="vec", label_col="label", num_factor=2, num_epochs=2, prediction_col="p",
        prediction_detail_col="d", device="cpu"), label_col="label")
    m = ovr.fit(TMem(three, "vec VECTOR, label STRING"))
    assert m.labels == ["a", "b", "c"]
    out = m.transform(TMem(three, "vec VECTOR, label STRING"))
    assert set(out.get_output_table().col("p")) <= {"a", "b", "c"}


def test_train_op_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tops.FmClassifierTrainBatchOp(vector_col="vec", label_col="label")
