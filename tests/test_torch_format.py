"""Slice 25 of the port: the format-conversion matrix
(``operator/batch/dataproc/format``), its stream twins
(``operator/stream/dataproc/format.py``) and the format transformers of
``pipeline/extras.py``, on the CPU against the JAX package.

* The names: ``FORMAT_OPS``, ``FORMAT_STREAM_OPS`` and
  ``FORMAT_TRANSFORMERS`` equal the JAX package's.
* Every op of the matrix on the same seeded table: host ops, held
  exactly (column names, types, cells; floats bitwise).
* The port's one difference: a ``…ToVectorBatchOp`` given
  ``vector_size`` whose rows all come out sparse writes vectors
  (``SPARSE_VECTOR``; columnar when the rows' entry counts agree), each
  row's vector equal to the JAX package's string parsed; without
  ``vector_size`` both write the same strings.
* A float32 logistic regression at 2^20 features through
  ``KvToVectorBatchOp`` is bitwise the one trained from the same
  ``SparseVector`` rows through ``MemSourceBatchOp``.
"""

import json

import numpy as np
import pytest
import torch

from alink_tpu.common.mtable import MTable as JT
from alink_tpu.operator.base import TableSourceBatchOp as JSrc
from alink_tpu.operator.batch.dataproc.format import FORMAT_OPS as JOPS
from alink_tpu.operator.stream.dataproc.format import \
    FORMAT_STREAM_OPS as JSOPS
from alink_tpu.operator.stream.source.sources import \
    MemSourceStreamOp as JMemS
from alink_tpu.pipeline.extras import FORMAT_TRANSFORMERS as JTRANS
from alink_tpu_torch.common.mtable import MTable as TT
from alink_tpu_torch.common.vector import (SparseVector, SparseVectorColumn,
                                           VectorUtil)
from alink_tpu_torch.operator.base import TableSourceBatchOp as TSrc
from alink_tpu_torch.operator.batch.dataproc.format import FORMAT_OPS as TOPS
from alink_tpu_torch.operator.stream.dataproc.format import \
    FORMAT_STREAM_OPS as TSOPS
from alink_tpu_torch.operator.stream.source.sources import \
    MemSourceStreamOp as TMemS
from alink_tpu_torch.pipeline.extras import FORMAT_TRANSFORMERS as TTRANS

SCHEMA = ("id LONG, f0 DOUBLE, f1 DOUBLE, f2 DOUBLE, csv STRING, "
          "json STRING, kv STRING, vec STRING, kvn STRING")
FIELDS = "f0 DOUBLE, f1 DOUBLE, f2 DOUBLE"
READ = {"Columns": dict(selected_cols=["f0", "f1", "f2"]),
        "Csv": dict(csv_col="csv", schema_str=FIELDS),
        "Json": dict(json_col="json"), "Kv": dict(kv_col="kvn"),
        "Vector": dict(vector_col="vec")}
WRITE = {"Columns": dict(schema_str=FIELDS, reserved_cols=["id"]), "Csv": dict(csv_col="csv_out"),
         "Json": dict(json_col="json_out"), "Kv": dict(kv_col="kv_out"),
         "Vector": dict(vector_col="vec_out"), "Triple": {}}


def _rows(n=40, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        f = [float(np.round(v, 3)) for v in rng.randn(3)]
        if i % 7 == 3:
            f[1] = None
        kv = ",".join(f"{k}:{v}" for k, v in enumerate(f) if v is not None)
        csv = ",".join("" if v is None else str(v) for v in f)
        js = json.dumps({f"f{k}": v for k, v in enumerate(f)})
        idx = sorted(rng.choice(8, 3, replace=False))
        vec = "$8$" + " ".join(f"{k}:{float(rng.randint(1, 9))}" for k in idx)
        if i % 5 == 0:
            vec = " ".join(str(v or 0.0) for v in f)   # a dense one
        kvn = ",".join(f"f{k}:{v}" for k, v in enumerate(f) if v is not None)
        out.append((i, f[0], f[1], f[2], csv, js, kv, vec, kvn))
    return out


def _cell(v):
    if isinstance(v, (float, np.floating)):
        return ("f", np.float64(v).tobytes())
    return ("o", str(v))


def same(got, want):
    assert got.col_names == want.col_names
    assert list(got.schema.types) == list(want.schema.types)
    assert got.num_rows == want.num_rows
    for c in got.col_names:
        assert [_cell(v) for v in got.col(c)] == \
            [_cell(v) for v in want.col(c)], c


def _same_vectors(got, want):
    """Each port vector, written by the JAX package's vector formatter
    (``VectorUtil.to_string``, copied), is the JAX op's string."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert isinstance(g, SparseVector) and isinstance(w, str)
        assert VectorUtil.to_string(g) == w


def test_the_matrices_name_the_jax_packages_ops():
    assert sorted(TOPS) == sorted(JOPS)
    assert sorted(TSOPS) == sorted(JSOPS)
    assert sorted(TTRANS) == sorted(JTRANS)
    # the port's operators carry no session id (each entry point takes
    # its device); every other param is the JAX package's
    for n, c in TSOPS.items():
        assert sorted(c.param_infos()) == sorted(
            set(JSOPS[n].param_infos()) - {"ml_environment_id"})


def _params(name):
    src, dst = name[:-len("BatchOp")].split("To")
    kw = {}
    if src in READ:
        kw.update(READ[src])
    elif src == "Any":
        kw.update(READ["Columns"])
    if dst in WRITE:
        kw.update(WRITE[dst])
    return src, dst, kw


def _triples(vector=False):
    cols = ["0", "2", "5"] if vector else ["f0", "f1", "f2"]
    rng = np.random.RandomState(1)
    rows = [(r, cols[c], float(np.round(rng.randn(), 3)))
            for r in range(12) for c in range(3) if (r + c) % 4]
    return rows, "row LONG, col STRING, val DOUBLE"


@pytest.mark.parametrize("name", sorted(JOPS))
def test_each_op_matches(name):
    src, dst, kw = _params(name)
    if src == "Triple":
        rows, schema = _triples(vector=dst == "Vector")
        kw.pop("reserved_cols", None)     # triples take none, as there
        kw.update(triple_row_col="row", triple_column_col="col",
                  triple_value_col="val")
    else:
        rows, schema = _rows(), SCHEMA
    got = TOPS[name](**kw).link_from(TSrc(TT(rows, schema)))
    want = JOPS[name](**kw).link_from(JSrc(JT(rows, schema)))
    same(got.get_output_table(), want.get_output_table())


@pytest.mark.parametrize("case", ["columns_to_kv", "columns_to_csv",
                                  "vector_to_kv"])
def test_equal_values_of_each_type_write_as_there(case):
    """The KV writer formats each float value once (a cache keyed by
    value): 1, True and 1.0 are equal keys, and 0.0, -0.0 and NaN must
    each keep their own string. Exact against the JAX package, but for
    its vector strings' -0.0, written ``0.0`` (as in
    ``test_kv_to_vector_whole_column_path_matches``)."""
    if case == "vector_to_kv":
        kv = ["1:0.0,2:1.5,3:nan", "1:-0.0,2:1.5,3:0.0",
              "1:nan,2:-0.0,3:1.5", "1:1.0,2:-0.0,3:0.0"]
        rows, schema = [(v,) for v in kv], "kv STRING"
        kw = dict(kv_col="kv", vector_col="v", vector_size=4)
        outs = []
        for ops, src, tab in ((TOPS, TSrc, TT), (JOPS, JSrc, JT)):
            vec = ops["KvToVectorBatchOp"](**kw).link_from(
                src(tab(rows, schema)))
            outs.append(list(ops["VectorToKvBatchOp"](
                vector_col="v", kv_col="back").link_from(vec)
                .get_output_table().col("back")))
        assert outs[0] == kv
        assert [v.replace(":-0.0", ":0.0") for v in outs[0]] == outs[1]
        return
    rows = [(1, True, 1.0, 0.0), (1, False, -0.0, float("nan")),
            (2, True, 2.0, -0.0), (0, True, float("nan"), 1.0)]
    schema = "a LONG, b BOOLEAN, c DOUBLE, d DOUBLE"
    to = case.split("_")[-1].capitalize()
    kw = {"Kv": dict(kv_col="out"), "Csv": dict(csv_col="out")}[to]
    name = f"ColumnsTo{to}BatchOp"
    got = TOPS[name](**kw).link_from(TSrc(TT(rows, schema)))
    want = JOPS[name](**kw).link_from(JSrc(JT(rows, schema)))
    g = list(got.get_output_table().col("out"))
    assert g == list(want.get_output_table().col("out"))
    if to == "Kv":
        assert g[:2] == ["a:1,b:True,c:1.0,d:0.0",
                         "a:1,b:False,c:-0.0,d:nan"]


@pytest.mark.parametrize("src", ["Kv", "Columns", "Json", "Csv"])
def test_to_vector_with_a_size_writes_vectors(src):
    name = f"{src}To" + "VectorBatchOp"
    rows = _rows()
    if src != "Kv":   # index keys: the Vector writer goes sparse
        rows = [(i, 1.0, 2.0, 3.0, "1.0,2.0,3.0",
                 json.dumps({"0": 1.5, "3": -2.0}), kv, vec, kvn)
                for i, _, _, _, _, _, kv, vec, kvn in rows]
    kw = dict(_params(name)[2], vector_size=16)
    if src == "Kv":
        kw["kv_col"] = "kv"
    if src == "Columns":
        kw["selected_cols"] = ["id"]
    got = TOPS[name](**kw).link_from(TSrc(TT(rows, SCHEMA)))
    want = JOPS[name](**kw).link_from(JSrc(JT(rows, SCHEMA)))
    g, w = got.get_output_table(), want.get_output_table()
    keys = {"Kv": "kv", "Columns": "id", "Json": "json", "Csv": "csv"}
    if src in ("Columns", "Csv"):
        # named keys, no indices: the JAX package's dense strings
        same(g, w)
        return
    assert g.schema.type_of("vec_out") == "SPARSE_VECTOR"
    assert w.schema.type_of("vec_out") == "STRING"
    _same_vectors(list(g.col("vec_out")), list(w.col("vec_out")))
    rest = [c for c in w.col_names if c != "vec_out"]
    same(g.select(rest), w.select(rest))
    assert keys[src] not in g.col_names


def test_equal_widths_go_columnar_and_round_trip():
    rng = np.random.RandomState(2)
    kv = [",".join(f"{k}:{float(rng.randint(1, 5))}" for k in
                   sorted(rng.choice(1 << 20, 39, replace=False)))
          for _ in range(50)]
    t = TT([(s, i) for i, s in enumerate(kv)], "kv STRING, y LONG")
    j = JT([(s, i) for i, s in enumerate(kv)], "kv STRING, y LONG")
    kw = dict(kv_col="kv", vector_col="v", vector_size=(1 << 20) + 1)
    got = TOPS["KvToVectorBatchOp"](**kw).link_from(TSrc(t))
    want = JOPS["KvToVectorBatchOp"](**kw).link_from(JSrc(j))
    col = got.get_output_table().col("v")
    assert isinstance(col, SparseVectorColumn) and col.idx.shape == (50, 39)
    _same_vectors(list(col), list(want.get_output_table().col("v")))
    back = TOPS["VectorToKvBatchOp"](vector_col="v", kv_col="kv").link_from(
        got).get_output_table()
    jback = JOPS["VectorToKvBatchOp"](vector_col="v", kv_col="kv").link_from(
        want).get_output_table()
    assert list(back.col("kv")) == list(jback.col("kv")) == kv


@pytest.mark.parametrize("name", ["KvToJsonBatchOp", "CsvToColumnsBatchOp",
                                  "VectorToColumnsBatchOp",
                                  "ColumnsToKvBatchOp"])
def test_stream_twins_match(name):
    sname = name.replace("BatchOp", "StreamOp")
    kw = _params(name)[2]
    rows = _rows(50, 3)
    got = TSOPS[sname](**kw).link_from(TMemS(rows, SCHEMA, batch_size=16))
    want = JSOPS[sname](**kw).link_from(JMemS(rows, SCHEMA, batch_size=16))
    g, w = list(got.timed_batches()), list(want.timed_batches())
    assert [t for t, _ in g] == [t for t, _ in w] and len(g) == 4
    for (_, a), (_, b) in zip(g, w):
        same(a, b)


@pytest.mark.parametrize("name", ["KvToColumns", "JsonToCsv", "VectorToKv"])
def test_transformers_match(name):
    kw = _params(name + "BatchOp")[2]
    rows = _rows(30, 4)
    got = TTRANS[name](**kw).transform(TSrc(TT(rows, SCHEMA)))
    want = JTRANS[name](**kw).transform(JSrc(JT(rows, SCHEMA)))
    same(got.get_output_table(), want.get_output_table())


def test_lr_through_kv_to_vector_is_bitwise_the_mem_source_route():
    """float32, 2^20 + 1 slots, 39 distinct non-zeros a row: the
    columnar column and the ``SparseVector`` rows give the trainer the
    same padded design, so the same model, bitwise."""
    from alink_tpu_torch.operator.batch.classification import \
        LogisticRegressionTrainBatchOp
    from alink_tpu_torch.operator.batch.source import MemSourceBatchOp
    dim = (1 << 20) + 1
    rng = np.random.RandomState(5)
    n = 300
    idx = np.sort(np.stack([rng.choice(dim, 39, replace=False)
                            for _ in range(n)]), 1)
    val = np.round(rng.rand(n, 39) * 3, 2) + 0.5
    y = (rng.rand(n) < 0.4).astype(np.int64)
    kv = [",".join(f"{k}:{v}" for k, v in zip(i, x))
          for i, x in zip(idx.tolist(), val.tolist())]
    kw = dict(vector_col="v", label_col="y", max_iter=6, device="cpu",
              dtype=torch.float32)
    via = TOPS["KvToVectorBatchOp"](kv_col="kv", vector_col="v",
                                    vector_size=dim).link_from(
        MemSourceBatchOp(TT({"kv": kv, "y": y}, "kv STRING, y LONG")))
    assert isinstance(via.get_output_table().col("v"), SparseVectorColumn)
    a = LogisticRegressionTrainBatchOp(**kw).link_from(via)
    vecs = np.empty(n, object)
    vecs[:] = [SparseVector(dim, i, x) for i, x in zip(idx, val)]
    b = LogisticRegressionTrainBatchOp(**kw).link_from(MemSourceBatchOp(
        TT({"y": y, "v": vecs}, "y LONG, v SPARSE_VECTOR")))
    ta, tb = a.get_output_table(), b.get_output_table()
    assert ta.to_rows() and [tuple(map(str, r)) for r in ta.to_rows()] == \
        [tuple(map(str, r)) for r in tb.to_rows()]
    la = np.asarray(a.get_side_output(0).get_output_table().col("loss"))
    lb = np.asarray(b.get_side_output(0).get_output_table().col("loss"))
    assert la.tobytes() == lb.tobytes() and len(la) > 1


def _kv_cases():
    rng = np.random.RandomState(7)
    bits = rng.randint(0, 2 ** 63, 60, dtype=np.int64).view(np.float64)
    wild = [v for v in bits.tolist() if np.isfinite(v)][:40] + [
        5e-324, -0.0, 1e-310, 1.7976931348623157e308, 0.1, 1e16, 123456789.0]
    uneven = [",".join(f"{k}:{v!r}" for k, v in zip(
        rng.choice(900, 1 + i % 5, replace=False), wild[i:i + 5]))
        for i in range(30)]
    even = [",".join(f"{k}:{v!r}" for k, v in zip(
        rng.randint(0, 10 ** 9 - 1, 3), wild[i:i + 3]))
        for i in range(40)]
    return {
        "even_wild_values": even,
        "uneven_widths": uneven,
        "unsorted_keys": ["5:1.0,2:2.5,9:-3e2", "1:0.5,0:7.,3:.25"],
        "repeated_key": ["3:1.0,3:2.0", "1:1.0,2:2.0"],
        "same_index_two_spellings": ["3:1.0,03:2.0", "1:1.0,2:2.0"],
        "spaces": [" 3:1.0, 4: 2.0", "1:1.0,2:2.0"],
        "item_without_value": ["3:1.0,junk,4:2.0", "1:1.0,2:2.0"],
        "exponents": ["1:1E5,2:-2.5e-3,3:+4", "1:1e0,2:2.,3:3"],
    }


@pytest.mark.parametrize("case", sorted(_kv_cases()))
def test_kv_to_vector_whole_column_path_matches(case):
    """Kv -> Vector (one row path: the KV reader, then the vector
    writer's columnar or per-row vectors) gives each row the JAX
    package's vector, on the widths, spellings and values that a
    whole-column parse would get wrong; Vector -> Kv gives the
    JAX package's strings, but for one difference: the JAX package's
    vector strings write -0.0 as ``0.0`` (its ``VectorUtil.to_string``),
    so its round trip loses the sign the port's vectors keep."""
    kv = _kv_cases()[case]
    size = 10 ** 9
    rows = [(s, i) for i, s in enumerate(kv)]
    kw = dict(kv_col="kv", vector_col="v", vector_size=size)
    got = TOPS["KvToVectorBatchOp"](**kw).link_from(
        TSrc(TT(rows, "kv STRING, y LONG")))
    want = JOPS["KvToVectorBatchOp"](**kw).link_from(
        JSrc(JT(rows, "kv STRING, y LONG")))
    g, w = got.get_output_table(), want.get_output_table()
    assert list(g.col("y")) == list(w.col("y"))
    _same_vectors(list(g.col("v")), list(w.col("v")))
    back = TOPS["VectorToKvBatchOp"](vector_col="v", kv_col="kv").link_from(
        got).get_output_table()
    jback = JOPS["VectorToKvBatchOp"](vector_col="v", kv_col="kv").link_from(
        want).get_output_table()
    got_kv = list(back.col("kv"))
    def jax_zero(v):
        return ",".join(t[:-4] + "0.0" if t.endswith(":-0.0") else t
                        for t in v.split(","))
    assert [jax_zero(v) for v in got_kv] == list(jback.col("kv"))
    assert (case == "even_wild_values") == any(
        t.endswith(":-0.0") for v in got_kv for t in v.split(","))
