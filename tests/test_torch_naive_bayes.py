"""Slice 23 of the port: naive Bayes on the CPU against the JAX package.

The same seeded tables train in both packages (the port with
``device="cpu"``). Tolerances:

* ``NaiveBayesTextTrainBatchOp`` (Multinomial and Bernoulli, sparse and
  dense vectors, with and without row weights): ``log_prior`` and
  ``log_prob`` within rtol 1e-12 of the JAX package's (the port sums the
  classes as a float64 product on the device, the JAX package as numpy
  row sums; measured bitwise without weights, 2.3e-16 relative with
  them); predicted labels
  equal, the detail probabilities within rtol 1e-12;
* the densified blocks (``design_blocks``): bitwise the host's
  ``SparseBatch.to_dense``, also when the rows split into several
  blocks;
* the mixed ``NaiveBayes`` (host numpy, a copy): the model table and the
  output rows equal cell for cell;
* each package's table loads in the other (through
  ``simple_model_table_from_reference`` one way, the JAX table type the
  other) and predicts the same labels;
* the pipeline stages ``NaiveBayesTextClassifier`` and ``NaiveBayes``
  fit and transform as the ops do.
"""

import json

import numpy as np
import pytest
import torch

from alink_tpu.common.mtable import MTable as JMTable
from alink_tpu.common.types import TableSchema as JSchema
from alink_tpu.common.vector import DenseVector as JDense
from alink_tpu.common.vector import SparseVector as JSparse
from alink_tpu.operator.batch.classification import naive_bayes as jnb
from alink_tpu.operator.batch.source import MemSourceBatchOp as JMem
from alink_tpu_torch.common.mtable import MTable as TMTable
from alink_tpu_torch.common.vector import DenseVector as TDense
from alink_tpu_torch.common.vector import SparseBatch
from alink_tpu_torch.common.vector import SparseVector as TSparse
from alink_tpu_torch.model.interop import simple_model_table_from_reference
from alink_tpu_torch.operator.batch.classification import naive_bayes as tnb
from alink_tpu_torch.operator.batch.source import MemSourceBatchOp as TMem
from alink_tpu_torch.operator.common.dataproc.feature_extract import \
    extract_design
from alink_tpu_torch.pipeline import fm_nb as pfm

RTOL = 1e-12
DIM, N, K = 30, 240, 3
OUT = dict(prediction_col="pred", prediction_detail_col="detail")


def _text_rows(seed=0, sparse=True, label_kind="str"):
    """Term-count vectors of K planted topics, labels as strings or
    longs, a positive weight a row."""
    rng = np.random.RandomState(seed)
    rates = rng.gamma(0.3, 2.0, (K, DIM))
    rows = []
    for _ in range(N):
        c = rng.randint(K)
        counts = rng.poisson(rates[c]).astype(float)
        idx = np.nonzero(counts)[0]
        label = f"t{c}" if label_kind == "str" else int(c * 10)
        rows.append((idx, counts[idx], counts, label,
                     float(rng.rand() * 2 + 0.1)))
    return rows


def _tables(rows, sparse):
    ltype = "STRING" if isinstance(rows[0][3], str) else "LONG"
    schema = f"vec VECTOR, label {ltype}, w DOUBLE"
    tr = [((TSparse(DIM, r[0], r[1]) if sparse else TDense(r[2])), r[3],
           r[4]) for r in rows]
    jr = [((JSparse(DIM, r[0], r[1]) if sparse else JDense(r[2])), r[3],
           r[4]) for r in rows]
    return TMTable(tr, schema), JMTable(jr, schema)


def _model_of(converter, op):
    return converter.load_model(op.get_output_table())


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("sparse", [True, False])
@pytest.mark.parametrize("model_type", ["Multinomial", "Bernoulli"])
def test_text_model_and_predictions_match_the_jax_package(model_type, sparse,
                                                          weighted):
    rows = _text_rows(seed=1)
    tt, jt = _tables(rows, sparse)
    kw = dict(vector_col="vec", label_col="label", model_type=model_type,
              smoothing=0.5)
    if weighted:
        kw["weight_col"] = "w"
    top = tnb.NaiveBayesTextTrainBatchOp(device="cpu", **kw).link_from(
        TMem(tt))
    jop = jnb.NaiveBayesTextTrainBatchOp(**kw).link_from(JMem(jt))
    tm = _model_of(tnb.NaiveBayesTextModelConverter(), top)
    jm = _model_of(jnb.NaiveBayesTextModelConverter(), jop)
    assert tm["labels"] == jm["labels"] == ["t0", "t1", "t2"]
    for key in ("log_prior", "log_prob"):
        np.testing.assert_allclose(tm[key], jm[key], rtol=RTOL, atol=0)
    tout = tnb.NaiveBayesTextPredictBatchOp(device="cpu", **OUT).link_from(
        top, TMem(tt)).get_output_table()
    jout = jnb.NaiveBayesTextPredictBatchOp(**OUT).link_from(
        jop, JMem(jt)).get_output_table()
    assert list(tout.col("pred")) == list(jout.col("pred"))
    acc = np.mean([p == r[3] for p, r in zip(tout.col("pred"), rows)])
    assert acc > 0.8
    for a, b in zip(tout.col("detail"), jout.col("detail")):
        da, db = json.loads(a), json.loads(b)
        assert da.keys() == db.keys()
        np.testing.assert_allclose([da[k] for k in da], [db[k] for k in da],
                                   rtol=RTOL, atol=1e-300)


def test_long_labels_keep_their_type():
    rows = _text_rows(seed=2, label_kind="long")
    tt, jt = _tables(rows, True)
    kw = dict(vector_col="vec", label_col="label")
    top = tnb.NaiveBayesTextTrainBatchOp(device="cpu", **kw).link_from(
        TMem(tt))
    jop = jnb.NaiveBayesTextTrainBatchOp(**kw).link_from(JMem(jt))
    assert _model_of(tnb.NaiveBayesTextModelConverter(), top)["labels"] \
        == _model_of(jnb.NaiveBayesTextModelConverter(), jop)["labels"] \
        == [0, 10, 20]
    tout = tnb.NaiveBayesTextPredictBatchOp(device="cpu", **OUT).link_from(
        top, TMem(tt)).get_output_table()
    jout = jnb.NaiveBayesTextPredictBatchOp(**OUT).link_from(
        jop, JMem(jt)).get_output_table()
    assert list(tout.col("pred")) == list(jout.col("pred"))
    assert tout.schema.type_of("pred") == jout.schema.type_of("pred")


@pytest.mark.parametrize("block_bytes", [1 << 28, 8 * (DIM + 2) * 7])
def test_design_blocks_are_the_hosts_dense_rows(block_bytes, monkeypatch):
    """The blocks densified on the device are the host's ``to_dense``
    bit for bit (a ``-0.0`` and padded rows included), in one block and
    in blocks of 7 rows."""
    monkeypatch.setattr(tnb, "DESIGN_BLOCK_BYTES", block_bytes)
    rows = _text_rows(seed=3)
    vecs = [TSparse(DIM, r[0], r[1]) for r in rows]
    vecs[5] = TSparse(DIM, [0, 4], [-0.0, 2.5])
    vecs[6] = TSparse(DIM, [], [])
    t = TMTable([(v,) for v in vecs], "vec VECTOR")
    design = extract_design(t, None, "vec", np.float64)
    want = SparseBatch(design["idx"], design["val"],
                       design["dim"]).to_dense(np.float64)
    parts = [(lo, hi, Xb.numpy()) for lo, hi, Xb in
             tnb.design_blocks(design, torch.device("cpu"), width=DIM + 2)]
    assert len(parts) == (1 if block_bytes > 1 << 20 else -(-N // 7))
    got = np.concatenate([p[2] for p in parts])
    assert got.shape == (N, DIM + 2) and not got[:, DIM:].any()
    np.testing.assert_array_equal(got[:, :DIM].view(np.int64),
                                  want.view(np.int64))


def _mixed_rows(n=300, seed=3):
    rng = np.random.RandomState(seed)
    color = np.where(rng.rand(n) < 0.5, "red", "blue")
    shape = rng.choice(["sq", "ci", "tr"], n)
    size = np.where(color == "red", rng.randn(n) + 3, rng.randn(n))
    label = np.where((color == "red") ^ (rng.rand(n) < 0.1), "A", "B")
    return [(str(c), str(s), float(z), str(l), float(w)) for c, s, z, l, w
            in zip(color, shape, size, label, rng.rand(n) + 0.5)]


MIXED_SCHEMA = "color STRING, shape STRING, size DOUBLE, label STRING, w DOUBLE"


@pytest.mark.parametrize("weighted", [False, True])
def test_mixed_naive_bayes_equals_the_jax_package(weighted):
    rows = _mixed_rows()
    kw = dict(feature_cols=["color", "shape", "size"], label_col="label",
              smoothing=0.7)
    if weighted:
        kw["weight_col"] = "w"
    top = tnb.NaiveBayesTrainBatchOp(**kw).link_from(TMem(rows, MIXED_SCHEMA))
    jop = jnb.NaiveBayesTrainBatchOp(**kw).link_from(JMem(rows, MIXED_SCHEMA))
    assert top.get_output_table().to_rows() == jop.get_output_table().to_rows()
    held = _mixed_rows(120, seed=4)
    held[3] = ("green", "sq", 1.0, "A", 1.0)          # an unseen category
    tout = tnb.NaiveBayesPredictBatchOp(**OUT).link_from(
        top, TMem(held, MIXED_SCHEMA)).get_output_table()
    jout = jnb.NaiveBayesPredictBatchOp(**OUT).link_from(
        jop, JMem(held, MIXED_SCHEMA)).get_output_table()
    assert tout.to_rows() == jout.to_rows()


def test_tables_carry_across_both_ways():
    rows = _text_rows(seed=5)
    tt, jt = _tables(rows, True)
    kw = dict(vector_col="vec", label_col="label", model_type="Bernoulli")
    top = tnb.NaiveBayesTextTrainBatchOp(device="cpu", **kw).link_from(
        TMem(tt))
    jop = jnb.NaiveBayesTextTrainBatchOp(**kw).link_from(JMem(jt))
    # the JAX package's table in the port, the port's in the JAX package
    into_port = simple_model_table_from_reference(
        jop.get_output_table().to_rows())
    into_jax = JMTable(top.get_output_table().to_rows(),
                       JSchema(["model_id", "model_info"], ["LONG", "STRING"]))
    a = tnb.NaiveBayesTextPredictBatchOp(device="cpu", **OUT).link_from(
        TMem(into_port), TMem(tt)).get_output_table()
    b = jnb.NaiveBayesTextPredictBatchOp(**OUT).link_from(
        JMem(jop.get_output_table()), JMem(jt)).get_output_table()
    c = jnb.NaiveBayesTextPredictBatchOp(**OUT).link_from(
        JMem(into_jax), JMem(jt)).get_output_table()
    d = tnb.NaiveBayesTextPredictBatchOp(device="cpu", **OUT).link_from(
        top, TMem(tt)).get_output_table()
    assert list(a.col("pred")) == list(b.col("pred"))
    assert list(c.col("pred")) == list(d.col("pred"))
    mixed = _mixed_rows()
    mkw = dict(feature_cols=["color", "shape", "size"], label_col="label")
    jm = jnb.NaiveBayesTrainBatchOp(**mkw).link_from(JMem(mixed, MIXED_SCHEMA))
    tm_table = simple_model_table_from_reference(
        jm.get_output_table().to_rows())
    e = tnb.NaiveBayesPredictBatchOp(**OUT).link_from(
        TMem(tm_table), TMem(mixed, MIXED_SCHEMA)).get_output_table()
    f = jnb.NaiveBayesPredictBatchOp(**OUT).link_from(
        jm, JMem(mixed, MIXED_SCHEMA)).get_output_table()
    assert e.to_rows() == f.to_rows()


def test_pipeline_stages_fit_and_transform():
    rows = _text_rows(seed=6)
    tt, _ = _tables(rows, True)
    kw = dict(vector_col="vec", label_col="label")
    model = pfm.NaiveBayesTextClassifier(device="cpu", prediction_col="pred",
                                         **kw).fit(TMem(tt))
    assert model.device == "cpu"
    got = model.transform(TMem(tt)).get_output_table()
    op = tnb.NaiveBayesTextTrainBatchOp(device="cpu", **kw).link_from(
        TMem(tt))
    want = tnb.NaiveBayesTextPredictBatchOp(
        device="cpu", prediction_col="pred").link_from(
        op, TMem(tt)).get_output_table()
    assert list(got.col("pred")) == list(want.col("pred"))
    assert model.get_local_predictor().predict(tt).col("pred").tolist() \
        == list(want.col("pred"))
    mixed = _mixed_rows()
    mkw = dict(feature_cols=["color", "shape", "size"], label_col="label")
    nb = pfm.NaiveBayes(prediction_col="pred", **mkw).fit(
        TMem(mixed, MIXED_SCHEMA))
    got = nb.transform(TMem(mixed, MIXED_SCHEMA)).get_output_table()
    want = tnb.NaiveBayesPredictBatchOp(prediction_col="pred").link_from(
        tnb.NaiveBayesTrainBatchOp(**mkw).link_from(
            TMem(mixed, MIXED_SCHEMA)),
        TMem(mixed, MIXED_SCHEMA)).get_output_table()
    assert got.to_rows() == want.to_rows()
