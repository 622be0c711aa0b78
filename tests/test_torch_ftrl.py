"""Slice 2 of the port: sparse online FTRL, held against the JAX package
on the CPU.

* Each step function of ``alink_tpu_torch/operator/stream/onlinelearning/
  ftrl.py`` against the JAX package's step factory at ``kernel="off"``
  (its XLA path) on a 1-device mesh, from the same state, on
  ``tests/test_kernels.py``'s ``_coo`` batches: ``z``, ``n`` and the
  margins within rtol 1e-12, atol 1e-14 in float64. Not bitwise: XLA's
  CPU reductions (``jnp.sum`` over a row, the correction matvecs) add in
  another order than torch's, and its ``exp`` is not torch's.
* ``FtrlTrainStreamOp`` against the JAX package's op on one sparse
  stream, both warm-started from one JAX-trained LR model table: every
  snapshot's coefficients within rtol 1e-10 (measured on this fixture:
  at most 1.7e-15 relative in sample mode, 5.1e-15 in staleness mode,
  1.5e-15 in chained mode).
* ``FtrlPredictStreamOp``'s labels equal the JAX package's; its details
  agree at rtol 1e-10.

The JAX side runs on an explicit 1-device environment: the tier-1
process's 8-device mesh would shard the state and move the last bits
of every margin's psum.
"""

import json

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from alink_tpu_torch.common.mtable import MTable as TMTable
from alink_tpu_torch.common.vector import DenseVector as TDense
from alink_tpu_torch.common.vector import SparseVector as TSparse
from alink_tpu_torch.kernels import ftrl as kf
from alink_tpu_torch.model.interop import (ftrl_state_from_numpy,
                                           ftrl_state_to_numpy,
                                           model_table_from_reference)
from alink_tpu_torch.operator.base import StreamOperator as TStreamOp
from alink_tpu_torch.operator.batch.source import MemSourceBatchOp as TMemB
from alink_tpu_torch.operator.common.linear.base import \
    LinearModelDataConverter as TConverter
from alink_tpu_torch.operator.stream.core import merge_timed as t_merge
from alink_tpu_torch.operator.stream.onlinelearning import ftrl as tf
from alink_tpu_torch.operator.stream.prefetch import prefetch
from alink_tpu_torch.operator.stream.sink import CollectSinkStreamOp as TSink
from alink_tpu_torch.operator.stream.source import MemSourceStreamOp as TMemS

HP = (0.05, 1.0, 1e-5, 1e-5)                  # alpha, beta, l1, l2
STREAM_KW = dict(vector_col="vec", label_col="label", alpha=0.05, beta=1.0,
                 l1=1e-5, l2=1e-5, time_interval=2.0, staleness=8,
                 chunk_size=8)


def _mesh1():
    return Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("d", "m"))


def _coo(B, dim, nnz, width, seed, dup_rows=0, repeat_rows=0):
    """tests/test_kernels.py's padded COO batch; ``dup_rows`` rows at the
    top share one feature block so chunks collide; ``repeat_rows`` rows at
    the top draw their slots from 20 with replacement, so a row repeats
    slots (as a ``SparseVector`` with duplicate indices does) and rows
    collide several times over."""
    rng = np.random.RandomState(seed)
    idx = np.zeros((B, width), np.int32)
    val = np.zeros((B, width))
    for i in range(B):
        if i < repeat_rows:
            idx[i, :nnz] = rng.choice(20, nnz, replace=True)
        elif i < dup_rows:
            idx[i, :nnz] = np.arange(nnz)
        else:
            idx[i, :nnz] = rng.choice(dim, nnz, replace=False)
    val[:, :nnz] = rng.randn(B, nnz)
    y = (rng.rand(B) < 0.5).astype(np.float64)
    return idx, val, y


def _state(dim, seed=3):
    rng = np.random.RandomState(seed)
    z = rng.randn(dim) * 0.1
    z[5] = -0.0                                # the signed-zero edge
    return z, np.abs(rng.randn(dim)) * 0.1


STEPS = {
    "sample": ("_ftrl_sparse_step_factory", {}, tf.ftrl_sample_step, {}),
    "staleness16": ("_ftrl_sparse_staleness_step_factory", {"K": 16},
                    tf.ftrl_staleness_step, {"K": 16}),
    "staleness1": ("_ftrl_sparse_staleness_step_factory", {"K": 1},
                   tf.ftrl_staleness_step, {"K": 1}),
    "chained8": ("_ftrl_sparse_chained_step_factory", {"K": 8},
                 tf.ftrl_chained_step, {"K": 8}),
}


@pytest.mark.parametrize("dup_rows", [0, 16, 24, "repeat"])
@pytest.mark.parametrize("mode", sorted(STEPS))
def test_step_matches_jax_xla_path(mode, dup_rows):
    """62 rows (padded to the chunk inside the step), 16 slots of width
    with 12 live, a 512-slot state with a -0.0. ``"repeat"``: the top 24
    rows repeat slots within the row."""
    import alink_tpu.operator.stream.onlinelearning.ftrl as jf
    fac_name, fac_kw, step, step_kw = STEPS[mode]
    dim = 512
    repeat = 24 if dup_rows == "repeat" else 0
    idx, val, y = _coo(62, dim, 12, 16, seed=0,
                       dup_rows=0 if repeat else dup_rows,
                       repeat_rows=repeat)
    if repeat:
        assert any(len(set(r[:12])) < 12 for r in idx[:repeat])
    z0, n0 = _state(dim)
    jstep = getattr(jf, fac_name)(_mesh1(), *HP, **fac_kw, kernel="off")
    zj, nj, mj = (np.asarray(a) for a in jstep(idx, val, y, z0, n0))
    z, n = ftrl_state_from_numpy(z0, n0, "cpu", torch.float64)
    z, n, m = step(torch.from_numpy(idx), torch.from_numpy(val),
                   torch.from_numpy(y), z, n, *HP, **step_kw)
    zt, nt = ftrl_state_to_numpy(z, n)
    assert m.shape == (62,) and zt.shape == (dim,)
    for got, want in ((zt, zj), (nt, nj), (m.numpy(), mj)):
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("mode,launches", [
    ("sample", {"gather_pair": 16, "walk_chunk": 16, "scatter_add_rows": 32}),
    ("staleness16", {"gather_rows": 4, "scatter_add_rows": 4}),
    ("chained8", {"gather_pair": 8, "walk_chunk": 8, "scatter_add_rows": 16})])
def test_step_hands_the_kernels_what_they_take(monkeypatch, mode, launches):
    """Every gather, scatter-add and chunk walk of a step goes through the
    kernel wrappers, with the operands the CUDA kernels take: contiguous,
    int32 slots, one dtype. (The CUDA path itself needs the card; on CPU
    tensors the wrappers run their plain versions.) 62 rows: 16 chunks
    of 4, 4 of 16, 8 of 8; the sample and chained steps make four calls a
    chunk (one ``gather_pair``, one ``walk_chunk``, two scatter-adds) and
    none per sample."""
    _, _, step, step_kw = STEPS[mode]
    calls = {}

    def checked(name, wrapper):
        def call(*args):
            tensors = [a for a in args if isinstance(a, torch.Tensor)]
            assert all(t.is_contiguous() for t in tensors), name
            assert len({t.dtype for t in tensors} - {torch.int32}) == 1
            ix = args[{"gather_pair": 2, "walk_chunk": 0}.get(name, 1)]
            assert ix.dtype == torch.int32
            assert ix.dim() == (2 if name == "walk_chunk" else 1)
            calls[name] = calls.get(name, 0) + 1
            return wrapper(*args)
        return call
    for name in ("gather_rows", "gather_pair", "scatter_add_rows",
                 "walk_chunk"):
        monkeypatch.setattr(tf, name, checked(name, getattr(kf, name)))
    idx, val, y = _coo(62, 512, 12, 16, seed=1, dup_rows=16)
    z, n = ftrl_state_from_numpy(*_state(512), "cpu", torch.float32)
    z, n, m = step(torch.from_numpy(idx), torch.from_numpy(val).float(),
                   torch.from_numpy(y).float(), z, n, *HP, **step_kw)
    assert m.shape == (62,) and z.is_contiguous() and n.is_contiguous()
    assert calls == launches


def test_sample_step_f32_matches_jax():
    """The card's ship dtype: float32 state and values against the JAX
    step in float32, within float32 rounding of the trajectory."""
    import alink_tpu.operator.stream.onlinelearning.ftrl as jf
    dim = 256
    idx, val, y = _coo(32, dim, 8, 8, seed=2, dup_rows=8)
    z0, n0 = _state(dim, seed=4)
    val, y = val.astype(np.float32), y.astype(np.float32)
    jstep = jf._ftrl_sparse_step_factory(_mesh1(), *HP, kernel="off")
    zj, nj, mj = (np.asarray(a) for a in jstep(
        idx, val, y, z0.astype(np.float32), n0.astype(np.float32)))
    z, n = ftrl_state_from_numpy(z0, n0, "cpu", torch.float32)
    z, n, m = tf.ftrl_sample_step(torch.from_numpy(idx),
                                  torch.from_numpy(val), torch.from_numpy(y),
                                  z, n, *HP)
    assert z.dtype == torch.float32 and m.dtype == torch.float32
    for got, want in ((z.numpy(), zj), (n.numpy(), nj), (m.numpy(), mj)):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_weights_match_jax():
    import alink_tpu.operator.stream.onlinelearning.ftrl as jf
    z, n = _state(300, seed=9)
    z[:20] = 0.5e-5                            # inside the l1 band
    want = np.asarray(jf._ftrl_weights(z, n, *HP))
    got = tf.ftrl_weights(torch.from_numpy(z), torch.from_numpy(n), *HP)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-15, atol=0)
    assert (got[:20] == 0).all()


# ---------------------------------------------------------------------------
# the stream operators against the JAX package's
# ---------------------------------------------------------------------------

DIM, NNZ, N = 200, 9, 150


def _rows(seed=7):
    rng = np.random.RandomState(seed)
    wtrue = rng.randn(DIM) * (rng.rand(DIM) < 0.3)
    idx = [np.sort(rng.choice(DIM, NNZ, False)) for _ in range(N)]
    val = [rng.randn(NNZ) for _ in range(N)]
    y = np.asarray([int(v @ wtrue[i] + 0.1 * rng.randn() > 0)
                    for i, v in zip(idx, val)])
    return idx, val, y


def _jax_table(rows):
    from alink_tpu.common.mtable import MTable
    from alink_tpu.common.vector import SparseVector
    idx, val, y = rows
    vecs = np.empty(N, object)
    vecs[:] = [SparseVector(DIM, i, v) for i, v in zip(idx, val)]
    return MTable({"vec": vecs, "label": y}, "vec VECTOR, label LONG")


def _torch_table(rows):
    idx, val, y = rows
    vecs = np.empty(N, object)
    vecs[:] = [TSparse(DIM, i, v) for i, v in zip(idx, val)]
    return TMTable({"vec": vecs, "label": y}, "vec VECTOR, label LONG")


@pytest.fixture(scope="module")
def stream_case():
    """A 1-device JAX environment, the rows, and an LR model trained by
    the JAX package on the first 40 rows (the warm start)."""
    from alink_tpu.common.mlenv import MLEnvironment, MLEnvironmentFactory
    from alink_tpu.operator.batch.classification.linear import (
        LogisticRegressionTrainBatchOp)
    from alink_tpu.operator.batch.source.sources import MemSourceBatchOp
    sid = MLEnvironmentFactory.register(
        MLEnvironment(parallelism=1, devices=jax.devices()[:1]))
    rows = _rows()
    warm = LogisticRegressionTrainBatchOp(
        vector_col="vec", label_col="label", max_iter=2,
        ml_environment_id=sid).link_from(
        MemSourceBatchOp(_jax_table(rows).first_n(40), ml_environment_id=sid))
    wt = warm.get_output_table()
    twarm = TMemB(model_table_from_reference(wt.to_rows(),
                                             wt.schema.types[2]))
    yield sid, rows, warm, twarm
    MLEnvironmentFactory.remove(sid)


def _jax_ops(stream_case, mode, batch_size=32):
    from alink_tpu.operator.stream.onlinelearning.ftrl import (
        FtrlPredictStreamOp, FtrlTrainStreamOp)
    from alink_tpu.operator.stream.source.sources import MemSourceStreamOp
    sid, rows, warm, _ = stream_case
    train = FtrlTrainStreamOp(warm, update_mode=mode, ml_environment_id=sid,
                              **STREAM_KW).link_from(
        MemSourceStreamOp(_jax_table(rows), batch_size=batch_size,
                          ml_environment_id=sid))
    pred = FtrlPredictStreamOp(warm, prediction_col="pred",
                               prediction_detail_col="det",
                               vector_col="vec",
                               ml_environment_id=sid).link_from(
        train, MemSourceStreamOp(_jax_table(rows), batch_size=25,
                                 ml_environment_id=sid))
    return train, pred


def _torch_ops(stream_case, mode, batch_size=32):
    _, rows, _, twarm = stream_case
    train = tf.FtrlTrainStreamOp(twarm, update_mode=mode, device="cpu",
                                 ship_dtype=torch.float64,
                                 **STREAM_KW).link_from(
        TMemS(_torch_table(rows), batch_size=batch_size))
    pred = tf.FtrlPredictStreamOp(twarm, prediction_col="pred",
                                  prediction_detail_col="det",
                                  vector_col="vec").link_from(
        train, TMemS(_torch_table(rows), batch_size=25))
    return train, pred


@pytest.mark.parametrize("mode", ["sample", "staleness", "chained"])
def test_train_stream_matches_jax(stream_case, mode):
    """150 rows in micro-batches of 32 (the last padded to 32 rows), a
    snapshot every 2 units of event time: the same snapshot times, and
    coefficients within rtol 1e-10."""
    from alink_tpu.operator.common.linear.base import LinearModelDataConverter
    jtrain, _ = _jax_ops(stream_case, mode)
    ttrain, _ = _torch_ops(stream_case, mode)
    jsnaps = [(t, LinearModelDataConverter.load_table(s).coef)
              for t, s in jtrain.timed_batches()]
    tsnaps = [(t, TConverter.load_table(s).coef)
              for t, s in ttrain.timed_batches()]
    assert [t for t, _ in tsnaps] == [t for t, _ in jsnaps] == [2.0, 4.0,
                                                                 6.0]
    for (_, got), (_, want) in zip(tsnaps, jsnaps):
        assert got.shape == (DIM + 1,)
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=0)
    pl = ttrain.progressive_logloss()
    assert [b for b, _ in pl] == [1, 2, 3, 4, 5]
    assert all(np.isfinite(v) and v > 0 for _, v in pl)


@pytest.mark.parametrize("mode", ["sample", "chained"])
def test_predict_stream_matches_jax(stream_case, mode):
    """Hot-swapped scoring: labels equal, details within rtol 1e-10."""
    _, jpred = _jax_ops(stream_case, mode)
    _, tpred = _torch_ops(stream_case, mode)
    jout = [(t, mt) for t, mt in jpred.timed_batches()]
    tout = [(t, mt) for t, mt in tpred.timed_batches()]
    assert [t for t, _ in tout] == [t for t, _ in jout]
    jl = [str(v) for _, mt in jout for v in mt.col("pred")]
    tl = [str(v) for _, mt in tout for v in mt.col("pred")]
    assert tl == jl and len(tl) == N
    for (_, a), (_, b) in zip(tout, jout):
        for da, db in zip(a.col("det"), b.col("det")):
            pa, pb = json.loads(da), json.loads(db)
            assert pa.keys() == pb.keys()
            np.testing.assert_allclose([pa[k] for k in pa],
                                       [pb[k] for k in pa], rtol=1e-10)


def test_empty_stream_emits_the_warm_start(stream_case):
    """No rows: one snapshot, the warm-start model through z0 = -coef *
    (beta/alpha + l2), as the JAX package emits it."""
    from alink_tpu.operator.common.linear.base import LinearModelDataConverter
    from alink_tpu.operator.stream.onlinelearning.ftrl import (
        FtrlTrainStreamOp)
    from alink_tpu.operator.stream.source.sources import MemSourceStreamOp
    sid, rows, warm, twarm = stream_case
    jop = FtrlTrainStreamOp(warm, ml_environment_id=sid,
                            **STREAM_KW).link_from(
        MemSourceStreamOp(_jax_table(rows).first_n(0),
                          ml_environment_id=sid))
    top = tf.FtrlTrainStreamOp(twarm, device="cpu",
                               ship_dtype=torch.float64,
                               **STREAM_KW).link_from(
        TMemS(_torch_table(rows).first_n(0)))
    (jt, js), = list(jop.timed_batches())
    (tt, ts), = list(top.timed_batches())
    assert tt == jt
    np.testing.assert_array_equal(
        TConverter.load_table(ts).coef,
        LinearModelDataConverter.load_table(js).coef)


def test_execute_drains_sinks_like_iteration(stream_case):
    """``StreamOperator.execute`` runs each registered sink's DAG (in a
    prefetch thread) to the same tables as iterating it."""
    train, pred = _torch_ops(stream_case, "staleness")
    sink_model, sink_pred = TSink().link_from(train), TSink().link_from(pred)
    TStreamOp.execute()
    models = sink_model.get_and_remove_values()
    scored = sink_pred.get_and_remove_values()
    direct = [mt for mt in pred.micro_batches()]
    snaps = list(train.micro_batches())
    assert len(snaps) == 3
    assert models.num_rows == sum(s.num_rows for s in snaps)
    assert list(models.col("model_info")) == [
        v for s in snaps for v in s.col("model_info")]
    assert scored.num_rows == N
    assert list(scored.col("pred")) == [v for mt in direct
                                        for v in mt.col("pred")]
    assert sink_pred.get_and_remove_values() is None


# ---------------------------------------------------------------------------
# the entry point's contract: the card by default, and no silent subset
# ---------------------------------------------------------------------------

def test_no_device_raises_without_cuda(monkeypatch, stream_case):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tf.FtrlTrainStreamOp(stream_case[3])
    op = tf.FtrlTrainStreamOp(stream_case[3], device="cpu")
    assert op.device == torch.device("cpu")


@pytest.mark.parametrize("kw", [{"checkpoint_dir": "/nonexistent",
                                 "health": True},
                                {"health": True}])
def test_left_out_options_raise(stream_case, kw):
    """Health monitoring is ported: a monitor attaches at link, with or
    without a checkpoint directory, and the drain feeds it the
    progressive-validation series of every micro-batch and the weight
    drift of every snapshot after the first (parity with the JAX
    package: tests/test_torch_health.py). No option of the op raises."""
    from alink_tpu_torch.common.health import HealthMonitor
    _, rows, _, twarm = stream_case
    mon = HealthMonitor(rules=[])
    op = tf.FtrlTrainStreamOp(twarm, device="cpu", label_col="label",
                              **{**kw, "health": mon})
    op.link_from(TMemS(_torch_table(rows), batch_size=32))
    snaps = list(op.timed_batches())
    assert len(snaps) > 1
    assert mon.series_names() == ["ftrl.pv_accuracy", "ftrl.pv_logloss",
                                  "ftrl.weight_drift", "nonfinite.margin"]
    batches = len(op.progressive_logloss())
    assert len(mon.series("ftrl.pv_logloss")[0]) == batches > 0
    assert len(mon.series("ftrl.weight_drift")[0]) == len(snaps) - 1


def test_progressive_logloss_is_the_same_bits_with_a_monitor(stream_case):
    """A drain queues only the log loss sum without a monitor and the three
    progressive-validation scalars with one: the progressive log loss is
    the same bits either way, and both keep a non-finite margin visible
    (NaN loss, never correct, counted) where the clip would hide it."""
    from alink_tpu_torch.common.health import HealthMonitor
    _, rows, _, twarm = stream_case
    got = []
    for kw in ({}, {"health": HealthMonitor(rules=[])}):
        op = tf.FtrlTrainStreamOp(twarm, device="cpu", label_col="label",
                                  **kw)
        op.link_from(TMemS(_torch_table(rows), batch_size=32))
        list(op.timed_batches())
        got.append(op.progressive_logloss())
    assert len(got[0]) > 1 and got[0] == got[1]
    mg = torch.tensor([2.0, -1.0, float("inf"), float("nan")],
                      dtype=torch.float64)
    y = torch.tensor([1.0, 1.0, 0.0, 1.0], dtype=torch.float64)
    ll = tf.pv_logloss_sum(mg, y)
    stats = tf.pv_stats(mg, y)
    assert torch.isnan(ll) and torch.isnan(stats[0])
    assert stats[1:].tolist() == [1.0, 2.0]
    assert torch.equal(tf.pv_logloss_sum(mg[:2], y[:2]),
                       tf.pv_stats(mg[:2], y[:2])[0])


def test_dense_vector_rows_train_like_the_sparse_ones(stream_case):
    """Dense vectors in the vector column take the strict dense step: a
    dense row equal to a sparse one gives the same snapshot (rtol 1e-12;
    the margin sums its terms in another order)."""
    _, rows, _, twarm = stream_case
    idx, val, y = rows
    dense, sparse = np.empty(8, object), np.empty(8, object)
    for i in range(8):
        x = np.zeros(DIM)
        x[idx[i]] = val[i]
        dense[i], sparse[i] = TDense(x), TSparse(DIM, idx[i], val[i])
    snaps = []
    for vecs in (dense, sparse):
        op = tf.FtrlTrainStreamOp(twarm, device="cpu", vector_col="vec",
                                  label_col="label", vector_size=DIM,
                                  ship_dtype=torch.float64).link_from(
            TMemS(TMTable({"vec": vecs, "label": y[:8]},
                          "vec VECTOR, label LONG"), batch_size=4))
        snaps.append([TConverter.load_table(s).coef
                      for s in op.micro_batches()])
    assert len(snaps[0]) == len(snaps[1]) == 2
    for a, b in zip(*snaps):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-15)


def test_out_of_range_feature_raises(stream_case):
    _, rows, _, twarm = stream_case
    vecs = np.empty(1, object)
    vecs[:] = [TSparse(DIM + 5, np.asarray([DIM + 2]), np.ones(1))]
    bad = TMTable({"vec": vecs, "label": np.ones(1, np.int64)},
                  "vec VECTOR, label LONG")
    op = tf.FtrlTrainStreamOp(twarm, device="cpu", vector_col="vec",
                              label_col="label").link_from(TMemS(bad))
    with pytest.raises(IndexError):
        list(op.timed_batches())


# ---------------------------------------------------------------------------
# the stream runtime pieces
# ---------------------------------------------------------------------------

def test_merge_timed_matches_jax():
    from alink_tpu.operator.stream.core import merge_timed as j_merge
    a = [(0.0, "m0"), (2.0, "m1"), (4.0, "m2")]
    b = [(0.0, "d0"), (1.0, "d1"), (2.0, "d2"), (3.0, "d3"), (5.0, "d4")]
    got = [(t, i, x) for t, i, x in t_merge(iter(a), iter(b))]
    assert got == [(t, i, x) for t, i, x in j_merge(iter(a), iter(b))]
    assert got[:3] == [(0.0, 0, "m0"), (0.0, 1, "d0"), (1.0, 1, "d1")]


def test_prefetch_keeps_order_and_reraises():
    assert list(prefetch(iter(range(50)))) == list(range(50))

    def boom():
        yield 1
        raise KeyError("upstream")
    it = prefetch(boom())
    assert next(it) == 1
    with pytest.raises(KeyError, match="upstream"):
        next(it)


def test_prefetch_consumer_stop_closes_upstream():
    closed = []

    def src():
        try:
            for i in range(10 ** 6):
                yield i
        finally:
            closed.append(True)
    it = prefetch(src())
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    it.close()
    assert closed == [True]
