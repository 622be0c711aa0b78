"""Slice 24 of the port: the indexers, the vector ops and the stateless
stream twins on the CPU against the JAX package.

All of these run on the host in numpy and Python in both packages, so
the tolerance is 0: equal model tables, equal output cells (compared by
their ``repr``, which prints every float's shortest repr).

* ``StringIndexerTrainBatchOp`` in each ``string_order_type`` (the
  frequency orders' ties broken by the token, a stable sort), with
  ``handle_invalid`` keep, skip and error; ``MultiStringIndexer``;
  ``IndexToStringPredictBatchOp`` (with ``model_name_col``, out-of-range
  indices to ``None``) and the round trip.
* The nine stateless vector ops, the three vector scalers,
  ``VectorImputer`` (MEAN, MIN, MAX, VALUE; dense and sparse rows) and
  ``VectorSerializeBatchOp``.
* The stateless stream twins (Binarizer, Bucketizer, DCT and the eight
  vector ops): over two micro-batches, row for row their batch op's and
  the JAX package's twin's (DCT's within 1e-12 of each row's largest
  |y|, torch's FFT against jnp's). The DCT and VectorAssembler twins
  open on their empty probe in the port only: there the JAX package's
  batch op stands in for its twin.
"""

import inspect

import jax
import numpy as np
import pytest

from alink_tpu.common.mlenv import MLEnvironment as JEnv
from alink_tpu.common.mlenv import MLEnvironmentFactory as JFactory
from alink_tpu.operator.batch.dataproc import indexers as jix
from alink_tpu.operator.batch.dataproc import vector_ops as jvo
from alink_tpu.operator.batch.source import MemSourceBatchOp as JMem
from alink_tpu.operator.stream import batch_twins as jtw
from alink_tpu.operator.stream.source import MemSourceStreamOp as JMemS
from alink_tpu_torch.operator.batch.dataproc import indexers as tix
from alink_tpu_torch.operator.batch.dataproc import vector_ops as tvo
from alink_tpu_torch.operator.batch.source import MemSourceBatchOp as TMem
from alink_tpu_torch.operator.stream import batch_twins as ttw
from alink_tpu_torch.operator.stream.source import MemSourceStreamOp as TMemS

SCHEMA = ("c STRING, d STRING, k LONG, x DOUBLE, v STRING, w STRING, "
          "sv STRING, i LONG")


@pytest.fixture(autouse=True)
def jax_default_1dev():
    prev = JFactory.get_default()
    JFactory.set_default(JEnv(parallelism=1, devices=jax.devices()[:1]))
    yield
    JFactory.set_default(prev)


def _rows(n=240, seed=0, nan=0.0):
    rng = np.random.RandomState(seed)
    c = np.asarray(["b", "a", "c", "aa", "10", "2"])[
        np.minimum(rng.geometric(0.35, n) - 1, 5)]
    d = np.asarray(["p", "q", "r"])[rng.randint(0, 3, n)]
    k = rng.randint(0, 5, n)
    x = np.round(rng.randn(n) * 3, 2)
    V = rng.randn(n, 4) * [1.0, 4.0, 0.5, 2.0] + [0.0, 1.0, -2.0, 0.0]
    V[rng.rand(n, 4) < nan] = np.nan
    W = rng.randn(n, 2)
    v = [" ".join(repr(float(t)) for t in r) for r in V]
    w = [" ".join(repr(float(t)) for t in r) for r in W]
    sv = [f"$6$0:{float(a)} {2 + j % 3}:{float(b)}"
          for j, (a, b) in enumerate(V[:, :2])]
    i = rng.randint(-1, 7, n)
    return [(str(a), str(b), int(e), float(f), g, h, s, int(t))
            for a, b, e, f, g, h, s, t in zip(c, d, k, x, v, w, sv, i)]


def _same(t, j):
    assert t.col_names == j.col_names
    assert t.schema.types == j.schema.types
    assert repr(t.to_rows()) == repr(j.to_rows())


# -- indexers -----------------------------------------------------------------

ORDERS = ["random", "frequency_asc", "frequency_desc", "alphabet_asc",
          "alphabet_desc"]


@pytest.mark.parametrize("order", ORDERS)
def test_string_indexer_orders_equal_the_jax_package(order):
    rows, held = _rows(), _rows(120, seed=2)
    kw = dict(selected_col="c", string_order_type=order)
    t = tix.StringIndexerTrainBatchOp(**kw).link_from(TMem(rows, SCHEMA))
    j = jix.StringIndexerTrainBatchOp(**kw).link_from(JMem(rows, SCHEMA))
    assert t.get_output_table().to_rows() == j.get_output_table().to_rows()
    pk = dict(selected_col="c", output_col="ci")
    _same(tix.StringIndexerPredictBatchOp(**pk).link_from(
              t, TMem(held, SCHEMA)).get_output_table(),
          jix.StringIndexerPredictBatchOp(**pk).link_from(
              j, JMem(held, SCHEMA)).get_output_table())


@pytest.mark.parametrize("handle", ["keep", "skip", "error"])
def test_string_indexer_handle_invalid(handle):
    rows = _rows()
    unseen = [("zz",) + r[1:] for r in _rows(5, seed=9)]
    kw = dict(selected_col="c", string_order_type="alphabet_asc")
    t = tix.StringIndexerTrainBatchOp(**kw).link_from(TMem(rows, SCHEMA))
    j = jix.StringIndexerTrainBatchOp(**kw).link_from(JMem(rows, SCHEMA))
    pk = dict(selected_col="c", output_col="ci", handle_invalid=handle)
    if handle == "error":
        for pkg, m, src in ((tix, t, TMem), (jix, j, JMem)):
            with pytest.raises(ValueError, match="unseen"):
                pkg.StringIndexerPredictBatchOp(**pk).link_from(
                    m, src(unseen, SCHEMA))
        return
    _same(tix.StringIndexerPredictBatchOp(**pk).link_from(
              t, TMem(unseen, SCHEMA)).get_output_table(),
          jix.StringIndexerPredictBatchOp(**pk).link_from(
              j, JMem(unseen, SCHEMA)).get_output_table())


def test_multi_string_indexer_and_index_to_string():
    rows, held = _rows(), _rows(100, seed=3)
    kw = dict(selected_cols=["c", "d", "k"],
              string_order_type="frequency_desc")
    t = tix.MultiStringIndexerTrainBatchOp(**kw).link_from(TMem(rows, SCHEMA))
    j = jix.MultiStringIndexerTrainBatchOp(**kw).link_from(JMem(rows, SCHEMA))
    assert t.get_output_table().to_rows() == j.get_output_table().to_rows()
    pk = dict(selected_cols=["c", "d", "k"], output_cols=["ci", "di", "ki"])
    ti = tix.MultiStringIndexerPredictBatchOp(**pk).link_from(
        t, TMem(held, SCHEMA))
    ji = jix.MultiStringIndexerPredictBatchOp(**pk).link_from(
        j, JMem(held, SCHEMA))
    _same(ti.get_output_table(), ji.get_output_table())
    for col, model_col in (("di", "d"), ("i", "c"), ("ki", "k")):
        ik = dict(selected_col=col, output_col="back", model_name_col=model_col)
        tb = tix.IndexToStringPredictBatchOp(**ik).link_from(t, ti)
        jb = jix.IndexToStringPredictBatchOp(**ik).link_from(j, ji)
        _same(tb.get_output_table(), jb.get_output_table())
    back = tix.IndexToStringPredictBatchOp(
        selected_col="di", output_col="back", model_name_col="d").link_from(
        t, ti).get_output_table()
    assert list(back.col("back")) == list(back.col("d"))


def test_indexer_mappers_declare_their_output_schema():
    rows = _rows()
    t = tix.StringIndexerTrainBatchOp(selected_col="c").link_from(
        TMem(rows, SCHEMA))
    src = TMem(rows, SCHEMA)
    for mapper, params, table in (
            (tix.StringIndexerModelMapper, dict(selected_col="c",
                                                output_col="ci"),
             tix.StringIndexerPredictBatchOp(selected_col="c",
                                             output_col="ci")),
            (tix.IndexToStringModelMapper, dict(selected_col="i",
                                                output_col="s"),
             tix.IndexToStringPredictBatchOp(selected_col="i",
                                             output_col="s"))):
        from alink_tpu_torch.common.params import Params
        m = mapper(t.get_schema(), src.get_schema(), Params(params))
        m.load_model(t.get_output_table())
        out = table.link_from(t, src).get_output_table()
        assert m.get_output_schema().names == out.col_names
        assert m.get_output_schema().types == out.schema.types


# -- vector ops ---------------------------------------------------------------

VECTOR_OPS = [
    ("VectorAssemblerBatchOp", dict(selected_cols=["x", "v", "k"],
                                    output_col="all")),
    ("VectorAssemblerBatchOp", dict(selected_cols=["sv", "x"],
                                    output_col="all", reserved_cols=["c"])),
    ("VectorSliceBatchOp", dict(selected_col="v", indices=[3, 0])),
    ("VectorNormalizeBatchOp", dict(selected_col="v", output_col="n")),
    ("VectorNormalizeBatchOp", dict(selected_col="sv", p=1.0)),
    ("VectorElementwiseProductBatchOp", dict(selected_col="v",
                                             scaling_vector="1.0 -2.0 0.5 3.0")),
    ("VectorElementwiseProductBatchOp", dict(selected_col="sv",
                                             scaling_vector="1 2 3 4 5 6")),
    ("VectorInteractionBatchOp", dict(selected_cols=["v", "w"],
                                      output_col="vw")),
    ("VectorPolynomialExpandBatchOp", dict(selected_col="v", degree=3)),
    ("VectorPolynomialExpandBatchOp", dict(selected_col="w", output_col="p2")),
    ("VectorSizeHintBatchOp", dict(selected_col="v", size=4)),
    ("VectorSizeHintBatchOp", dict(selected_col="w", size=3,
                                   handle_invalid_method="skip")),
    ("VectorToColumnsBatchOp", dict(selected_col="w",
                                    output_cols=["w0", "w1"])),
    ("VectorSerializeBatchOp", dict()),
]


@pytest.mark.parametrize("name,kw", VECTOR_OPS,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(VECTOR_OPS)])
def test_vector_op_equals_the_jax_package(name, kw):
    rows = _rows(120)
    if name == "VectorSerializeBatchOp":
        assembled = dict(selected_cols=["x", "v"], output_col="all")
        t_in = tvo.VectorAssemblerBatchOp(**assembled).link_from(
            TMem(rows, SCHEMA))
        j_in = jvo.VectorAssemblerBatchOp(**assembled).link_from(
            JMem(rows, SCHEMA))
    else:
        t_in, j_in = TMem(rows, SCHEMA), JMem(rows, SCHEMA)
    t = getattr(tvo, name)(**kw).link_from(t_in)
    j = getattr(jvo, name)(**kw).link_from(j_in)
    _same(t.get_output_table(), j.get_output_table())
    assert "device" not in inspect.signature(
        getattr(tvo, name).__init__).parameters


@pytest.mark.parametrize("kind", ["Standard", "MinMax", "MaxAbs"])
@pytest.mark.parametrize("col", ["v", "sv"])
def test_vector_scalers_equal_the_jax_package(kind, col):
    rows, held = _rows(), _rows(80, seed=4)
    train = f"Vector{kind}ScalerTrainBatchOp"
    pred = f"Vector{kind}ScalerPredictBatchOp"
    t = getattr(tvo, train)(selected_col=col).link_from(TMem(rows, SCHEMA))
    j = getattr(jvo, train)(selected_col=col).link_from(JMem(rows, SCHEMA))
    assert t.get_output_table().to_rows() == j.get_output_table().to_rows()
    pk = dict(selected_col=col, output_col="o")
    _same(getattr(tvo, pred)(**pk).link_from(t, TMem(held, SCHEMA))
          .get_output_table(),
          getattr(jvo, pred)(**pk).link_from(j, JMem(held, SCHEMA))
          .get_output_table())


@pytest.mark.parametrize("strategy", ["MEAN", "MIN", "MAX", "VALUE"])
def test_vector_imputer_equals_the_jax_package(strategy):
    rows, held = _rows(nan=0.05), _rows(80, seed=5, nan=0.1)
    kw = dict(selected_col="v", strategy=strategy)
    if strategy == "VALUE":
        kw["fill_value"] = -7.5
    t = tvo.VectorImputerTrainBatchOp(**kw).link_from(TMem(rows, SCHEMA))
    j = jvo.VectorImputerTrainBatchOp(**kw).link_from(JMem(rows, SCHEMA))
    assert t.get_output_table().to_rows() == j.get_output_table().to_rows()
    out = tvo.VectorImputerPredictBatchOp(selected_col="v").link_from(
        t, TMem(held, SCHEMA)).get_output_table()
    _same(out, jvo.VectorImputerPredictBatchOp(selected_col="v").link_from(
        j, JMem(held, SCHEMA)).get_output_table())
    assert not any(np.isnan(vec.data).any() for vec in
                   (tvo.VectorUtil.parse(v) for v in out.col("v")))


def test_vector_imputer_fills_sparse_rows():
    rows = [("$5$0:1.0 3:nan",), ("$5$0:3.0 3:4.0",)]
    t = tvo.VectorImputerTrainBatchOp(selected_col="v").link_from(
        TMem(rows, "v STRING"))
    j = jvo.VectorImputerTrainBatchOp(selected_col="v").link_from(
        JMem(rows, "v STRING"))
    _same(tvo.VectorImputerPredictBatchOp(selected_col="v").link_from(
              t, TMem(rows, "v STRING")).get_output_table(),
          jvo.VectorImputerPredictBatchOp(selected_col="v").link_from(
              j, JMem(rows, "v STRING")).get_output_table())


# -- the stateless stream twins -----------------------------------------------

TWINS = {
    "BinarizerStreamOp": dict(selected_col="x", threshold=0.5),
    "BucketizerStreamOp": dict(selected_cols=["x"], cuts_array=[[-1.0, 1.0]]),
    "DCTStreamOp": dict(selected_col="v", output_col="f"),
    "VectorAssemblerStreamOp": dict(selected_cols=["x", "v"],
                                    output_col="all"),
    "VectorElementwiseProductStreamOp": dict(selected_col="w",
                                             scaling_vector="2.0 -1.0"),
    "VectorInteractionStreamOp": dict(selected_cols=["v", "w"],
                                      output_col="vw"),
    "VectorNormalizeStreamOp": dict(selected_col="v"),
    "VectorPolynomialExpandStreamOp": dict(selected_col="w", degree=2),
    "VectorSizeHintStreamOp": dict(selected_col="v", size=4),
    "VectorSliceStreamOp": dict(selected_col="v", indices=[1, 2]),
    "VectorSerializeStreamOp": dict(),
}


def _drain(op):
    batches = list(op.micro_batches())
    rows = [r for mt in batches for r in mt.to_rows()]
    return len(batches), rows, batches[0].col_names if batches else None


@pytest.mark.parametrize("name", sorted(TWINS))
def test_twin_equals_its_batch_op_and_the_jax_twin(name):
    rows = _rows(100, seed=6)
    kw = TWINS[name]
    twin = ttw.TWIN_STREAM_OPS[name]
    dev = {"device": "cpu"} if name == "DCTStreamOp" else {}
    parts, got, names = _drain(twin(**kw, **dev).link_from(
        TMemS(rows, SCHEMA, batch_size=50)))
    assert parts == 2
    batch = twin._batch_cls(twin)(**kw, **dev).link_from(
        TMem(rows, SCHEMA)).get_output_table()
    assert names == batch.col_names
    assert repr(got) == repr(batch.to_rows())
    if name in ("DCTStreamOp", "VectorAssemblerStreamOp"):
        with pytest.raises(ValueError):      # its empty probe cannot stack
            getattr(jtw, name)(**kw).link_from(
                JMemS(rows, SCHEMA, batch_size=50))
        jb = getattr(jtw, name)._batch_cls(None)(**kw).link_from(
            JMem(rows, SCHEMA)).get_output_table()
        if name == "VectorAssemblerStreamOp":
            assert repr(jb.to_rows()) == repr(got)
            return
        Yt = np.stack([v.data for v in batch.col("f")])
        Yj = np.stack([v.data for v in jb.col("f")])
        scale = np.abs(Yj).max(1, keepdims=True)
        assert (np.abs(Yt - Yj) / scale).max() <= 1e-12
        return
    jtwin = getattr(jtw, name)(**kw).link_from(
        JMemS(rows, SCHEMA, batch_size=50))
    jparts, jgot, jnames = _drain(jtwin)
    assert jparts == 2 and jnames == names
    assert repr(jgot) == repr(got)
