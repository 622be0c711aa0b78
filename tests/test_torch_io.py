"""The port's file path against the JAX package's on the CPU: ``io/csv.py``
and ``io/sharding.py``, the file sources and sinks (batch and stream),
``prefetch_map``, the native fast path of ``extract_design`` and a LibSVM
file trained by L-BFGS.

* Reads: ``read_csv`` (the native numeric path, the Python path, empty
  cells, header drop with a quoted newline) and ``read_libsvm`` give the
  JAX package's tables on the same files, whole and by shard; over n
  shards of one file and of a glob the shards are disjoint and their
  union is the whole.
* Writes: ``write_csv`` / ``write_libsvm`` and the row formatters write
  the JAX package's bytes, and read back to the table (floats by
  ``repr``, so bitwise).
* The operators give the JAX package's tables, files and micro-batches.
* ``prefetch_map`` keeps its input's order at any width, and an error of
  item k arrives after items 0..k-1.
* ``io/fieldblock.py``'s loader reads a field-blocked LibSVM file in
  shards to the JAX package's ``parse_libsvm_fb16`` of the whole file,
  and refuses rows that are not field-blocked.
* ``extract_design`` on a column of sparse-vector literals equals the
  JAX package's native fast path bitwise, and the per-row parse on
  literals written in index order.
* A LibSVM file through ``LibSvmSourceBatchOp`` trains 10 L-BFGS
  supersteps to the JAX package's coefficients at rtol 1e-10 (float64),
  and to the same table trained from memory bitwise.
"""

import os
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from alink_tpu_torch.common.mtable import MTable as TMTable
from alink_tpu_torch.common.types import TableSchema as TSchema
from alink_tpu_torch.common.vector import SparseVector as TSparse
from alink_tpu_torch.io import csv as tcsv
from alink_tpu_torch.io import sharding as tsh
from alink_tpu_torch.operator.batch import sink as tbsink
from alink_tpu_torch.operator.batch import source as tbsrc
from alink_tpu_torch.operator.base import StreamOperator as TStream
from alink_tpu_torch.operator.common.dataproc import \
    feature_extract as tfe
from alink_tpu_torch.operator.stream import sink as tssink
from alink_tpu_torch.operator.stream import source as tssrc
from alink_tpu_torch.operator.stream.prefetch import prefetch_map


def _jcsv():
    from alink_tpu.io import csv
    return csv


def _norm(v):
    """One cell as a comparable value: floats by their bits, vectors by
    their size, indices and value bits."""
    if v is None or isinstance(v, (str, bytes, bool, np.bool_)):
        return v
    if isinstance(v, (int, np.integer)):
        return ("i", int(v))
    if isinstance(v, (float, np.floating)):
        return ("f", np.float64(v).tobytes())
    if hasattr(v, "indices"):
        return ("sv", v.n, np.asarray(v.indices).tolist(),
                np.asarray(v.values, np.float64).tobytes())
    if hasattr(v, "data"):
        return ("dv", np.asarray(v.data, np.float64).tobytes())
    raise TypeError(type(v))


def _rows(t):
    return [tuple(_norm(v) for v in r) for r in t.rows()]


def _same_table(got, want):
    assert list(got.schema.names) == list(want.schema.names)
    assert [s.upper() for s in got.schema.types] == \
        [s.upper() for s in want.schema.types]
    assert _rows(got) == _rows(want)


NUMS = ["1", "-2.5", "3e2", "-4.25E-3", "1.2345678901234567", "-0",
        "98765432109876543", "0.1", "7"]

CSV_CASES = {
    # name: (schema, delimiter, empty cells, header)
    "numeric": ("id LONG, x DOUBLE, y DOUBLE", ",", False, None),
    "numeric_semicolon": ("id LONG, x DOUBLE, y DOUBLE", ";", False,
                          "id;x;y"),
    "numeric_empty_cells": ("id LONG, x DOUBLE, y DOUBLE", ",", True, None),
    "mixed": ("id LONG, x DOUBLE, s STRING, b BOOLEAN, v VECTOR", ",", True,
              '"id","x\nnote",s,b,v'),
}


def _csv_text(case, rows=90, seed=0, first_id=0):
    schema, delim, empty, header = CSV_CASES[case]
    rng = np.random.RandomState(seed)
    lines = [header] if header else []
    for i in range(rows):
        cells = [str(first_id + i), NUMS[rng.randint(len(NUMS))]]
        if "y DOUBLE" in schema:
            cells.append(NUMS[rng.randint(len(NUMS))])
        else:
            cells += [f'"w{rng.randint(9)},{rng.randint(9)}"',
                      ["true", "false", "1"][rng.randint(3)],
                      f"$9${rng.randint(4)}:{NUMS[rng.randint(len(NUMS))]} "
                      f"6:2.5"]
        if empty and i % 5 == 1:
            cells[1] = ""
        lines.append(delim.join(cells))
    return "\n".join(lines) + "\n"


def _write(path, text):
    with open(path, "w", encoding="utf-8") as f:
        f.write(text)
    return str(path)


@pytest.mark.parametrize("case", sorted(CSV_CASES))
def test_read_csv_matches_the_jax_package(case, tmp_path):
    from alink_tpu.common.types import TableSchema as JSchema
    schema, delim, _, header = CSV_CASES[case]
    path = _write(tmp_path / "t.csv", _csv_text(case))
    got = tcsv.read_csv(path, TSchema.parse(schema), delim,
                        ignore_first_line=header is not None)
    want = _jcsv().read_csv(path, JSchema.parse(schema), delim,
                            ignore_first_line=header is not None)
    _same_table(got, want)
    assert got.num_rows == 90


def test_header_that_never_closes_its_quote_is_refused(tmp_path):
    path = _write(tmp_path / "t.csv", '"a\n' + "x\n" * 70)
    for mod in (tcsv, _jcsv()):
        with pytest.raises(ValueError, match="64 physical lines"):
            mod._load_line_bytes(path, True)


def _shard_ids(table):
    return [int(v) for v in table.col("id")]


@pytest.mark.parametrize("layout", ["one_file", "glob"])
@pytest.mark.parametrize("n", [1, 2, 3, 5])
@pytest.mark.parametrize("case", ["numeric", "mixed"])
def test_csv_shards_are_disjoint_and_complete(case, n, layout, tmp_path):
    from alink_tpu.common.types import TableSchema as JSchema
    schema, delim, _, header = CSV_CASES[case]
    if layout == "one_file":
        path = _write(tmp_path / "t.csv", _csv_text(case, rows=97))
        total = 97
    else:
        for k in range(4):
            _write(tmp_path / f"part-{k}.csv",
                   _csv_text(case, rows=20 + k, seed=k, first_id=100 * k))
        path = str(tmp_path / "part-*.csv")
        total = sum(20 + k for k in range(4))
    ids = []
    for i in range(n):
        got = tcsv.read_csv(path, TSchema.parse(schema), delim,
                            ignore_first_line=header is not None,
                            shard=(i, n))
        want = _jcsv().read_csv(path, JSchema.parse(schema), delim,
                                ignore_first_line=header is not None,
                                shard=(i, n))
        _same_table(got, want)
        ids += _shard_ids(got)
    assert len(ids) == len(set(ids)) == total


def _libsvm_text(rng, rows, dim=60, first_label=0):
    lines = []
    for i in range(rows):
        k = rng.randint(0, 6)
        idx = np.sort(rng.choice(dim, k, replace=False)) + 1
        vals = rng.randn(k) * 10.0 ** rng.randint(-3, 4, k)
        lines.append(" ".join([str(first_label + i)]
                              + [f"{j}:{v!r}" for j, v in zip(idx, vals)]))
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("layout", ["one_file", "glob"])
@pytest.mark.parametrize("n", [1, 2, 4, 7])
def test_libsvm_shards_are_disjoint_and_complete(n, layout, tmp_path):
    rng = np.random.RandomState(n)
    if layout == "one_file":
        path = _write(tmp_path / "t.svm", _libsvm_text(rng, 211))
        total = 211
    else:
        for k in range(3):
            _write(tmp_path / f"part-{k}.svm",
                   _libsvm_text(rng, 30 + k, first_label=1000 * k))
        path = str(tmp_path / "part-*.svm")
        total = 93
    whole = tcsv.read_libsvm(path, shard=(0, 1), vector_size=60)
    _same_table(whole, _jcsv().read_libsvm(path, shard=(0, 1),
                                           vector_size=60))
    labels = []
    for i in range(n):
        got = tcsv.read_libsvm(path, shard=(i, n), vector_size=60)
        _same_table(got, _jcsv().read_libsvm(path, shard=(i, n),
                                             vector_size=60))
        labels += [float(v) for v in got.col("label")]
    assert len(labels) == len(set(labels)) == total
    assert sorted(labels) == sorted(float(v) for v in whole.col("label"))


@pytest.mark.parametrize("start_index", [0, 1])
def test_read_libsvm_infers_the_width(start_index, tmp_path):
    path = _write(tmp_path / "t.svm",
                  "1 3:1.5 7:2\n\n0\r\n-1\t2:0.25\n")
    got = tcsv.read_libsvm(path, start_index)
    _same_table(got, _jcsv().read_libsvm(path, start_index))
    assert got.col("features")[0].n == 8 - start_index
    with pytest.raises(ValueError, match="positive"):
        tcsv.read_libsvm(path, vector_size=0)


def _table_pair(kind, n=40, seed=0):
    """The same table in both packages."""
    from alink_tpu.common.mtable import MTable as JMTable
    from alink_tpu.common.vector import DenseVector as JDense
    from alink_tpu.common.vector import SparseVector as JSparse
    from alink_tpu_torch.common.vector import DenseVector as TDense
    rng = np.random.RandomState(seed)
    out = []
    for MT, SV, DV in ((JMTable, JSparse, JDense), (TMTable, TSparse, TDense)):
        r = np.random.RandomState(seed)
        if kind == "text":
            out.append(MT({"t": np.array([f"line {i}, x" for i in range(n)],
                                         object)}, "t STRING"))
            continue
        vecs = np.empty(n, object)
        for i in range(n):
            if kind == "dense" and i % 2:
                vecs[i] = DV(r.randn(5) * (r.rand(5) < 0.6))
            else:
                k = r.randint(0, 5)
                vecs[i] = SV(30, np.sort(r.choice(30, k, replace=False)),
                             r.randn(k) * 1e-3)
        s = np.array([f"s{i}" if i % 3 else None for i in range(n)], object)
        out.append(MT({"label": (r.rand(n) < 0.5).astype(np.float64),
                       "s": s, "vec": vecs},
                      "label DOUBLE, s STRING, vec VECTOR"))
    del rng
    return out


@pytest.mark.parametrize("with_header", [False, True])
@pytest.mark.parametrize("kind", ["sparse", "dense"])
def test_write_csv_writes_the_jax_packages_bytes(kind, with_header,
                                                 tmp_path):
    jt, tt = _table_pair(kind)
    tcsv.write_csv(tt, str(tmp_path / "t.csv"), with_header=with_header)
    _jcsv().write_csv(jt, str(tmp_path / "j.csv"), with_header=with_header)
    data = (tmp_path / "t.csv").read_bytes()
    assert data == (tmp_path / "j.csv").read_bytes()
    assert tcsv.format_csv_rows(tt, ";") == _jcsv().format_csv_rows(jt, ";")
    back = tcsv.read_csv(str(tmp_path / "t.csv"),
                         TSchema.parse("label DOUBLE, s STRING, vec VECTOR"),
                         ignore_first_line=with_header)
    assert [float(v) for v in back.col("label")] == list(tt.col("label"))


@pytest.mark.parametrize("start_index", [0, 1])
@pytest.mark.parametrize("kind", ["sparse", "dense"])
def test_write_libsvm_round_trips_bitwise(kind, start_index, tmp_path):
    jt, tt = _table_pair(kind)
    path = str(tmp_path / "t.svm")
    tcsv.write_libsvm(tt, path, "label", "vec", start_index)
    _jcsv().write_libsvm(jt, str(tmp_path / "j.svm"), "label", "vec",
                         start_index)
    assert (tmp_path / "t.svm").read_bytes() == \
        (tmp_path / "j.svm").read_bytes()
    assert tcsv.format_libsvm_rows(tt, "label", "vec", start_index) == \
        _jcsv().format_libsvm_rows(jt, "label", "vec", start_index)
    back = tcsv.read_libsvm(path, start_index, vector_size=30)
    assert list(back.col("label")) == list(tt.col("label"))
    if kind == "sparse":
        for a, b in zip(back.col("features"), tt.col("vec")):
            assert _norm(a) == _norm(b)


@pytest.mark.parametrize("args,want", [
    ((None, None), (0, 1)), ((None, 1), (0, 1)), ((2, 4), (2, 4)),
    ((0, 1), (0, 1)), ((1, None), ValueError), ((None, 2), ValueError),
    ((4, 4), ValueError), ((-1, 3), ValueError)])
def test_resolve_shard(args, want):
    if want is ValueError:
        with pytest.raises(ValueError):
            tsh.resolve_shard(*args)
    else:
        assert tsh.resolve_shard(*args) == want


def test_expand_paths(tmp_path):
    from alink_tpu.io import sharding as jsh
    for k in (2, 0, 1):
        _write(tmp_path / f"p-{k}.txt", "x\n")
    _write(tmp_path / "lit[1].txt", "x\n")
    for pat in ("p-*.txt", "p-?.txt", "lit[1].txt", "none.txt"):
        p = str(tmp_path / pat)
        assert tsh.expand_paths(p) == jsh.expand_paths(p)
    with pytest.raises(FileNotFoundError):
        tsh.expand_paths(str(tmp_path / "q-*.txt"))


# -- the operators ----------------------------------------------------------

def _jsrc():
    from alink_tpu.operator.batch.source import sources
    return sources


def _batch_sources(kind, path):
    """(port op, JAX op) reading one file."""
    if kind == "csv":
        kw = dict(file_path=path, schema_str=CSV_CASES["mixed"][0],
                  ignore_first_line=True)
        return tbsrc.CsvSourceBatchOp(**kw), _jsrc().CsvSourceBatchOp(**kw)
    if kind == "libsvm":
        kw = dict(file_path=path, vector_size=60)
        return (tbsrc.LibSvmSourceBatchOp(**kw),
                _jsrc().LibSvmSourceBatchOp(**kw))
    return (tbsrc.TextSourceBatchOp().set_file_path(path),
            _jsrc().TextSourceBatchOp().set_file_path(path))


def _fixture_file(kind, tmp_path):
    if kind == "libsvm":
        return _write(tmp_path / "t.svm",
                      _libsvm_text(np.random.RandomState(3), 120))
    return _write(tmp_path / "t.csv", _csv_text("mixed"))


@pytest.mark.parametrize("kind", ["csv", "libsvm", "text"])
def test_batch_sources_match_the_jax_package(kind, tmp_path):
    path = _fixture_file(kind, tmp_path)
    got, want = _batch_sources(kind, path)
    _same_table(got.get_output_table(), want.get_output_table())
    with pytest.raises(RuntimeError, match="source"):
        got.link_from(tbsrc.MemSourceBatchOp([(1,)], "a INT"))


@pytest.mark.parametrize("kind", ["csv", "libsvm"])
def test_sharded_source_union_is_the_whole(kind, tmp_path):
    path = _fixture_file(kind, tmp_path)
    whole = _batch_sources(kind, path)[0].get_output_table()
    parts = []
    for i in range(4):
        op, jop = _batch_sources(kind, path)
        for o in (op, jop):
            o.set_sharded(True).set_shard_index(i).set_num_shards(4)
        part = op.get_output_table()
        _same_table(part, jop.get_output_table())
        parts += _rows(part)
    assert parts == _rows(whole)
    op = _batch_sources(kind, path)[0].set_sharded(True).set_num_shards(4)
    with pytest.raises(ValueError, match="shard_index"):
        op.get_output_table()


def _jsink():
    from alink_tpu.operator.batch.sink import sinks
    return sinks


@pytest.mark.parametrize("kind", ["csv", "libsvm", "text"])
def test_batch_sinks_write_the_jax_packages_files(kind, tmp_path):
    from alink_tpu.operator.batch.source import MemSourceBatchOp as JMem
    jt, tt = _table_pair("text" if kind == "text" else "sparse")
    outs = []
    for mod, Mem, t, name in ((tbsink, tbsrc.MemSourceBatchOp, tt, "t"),
                              (_jsink(), JMem, jt, "j")):
        path = str(tmp_path / f"{name}.out")
        if kind == "csv":
            op = mod.CsvSinkBatchOp(file_path=path, with_header=True)
        elif kind == "libsvm":
            op = mod.LibSvmSinkBatchOp(file_path=path, label_col="label",
                                       vector_col="vec")
        else:
            op = mod.TextSinkBatchOp(file_path=path)
        out = op.link_from(Mem(t)).get_output_table()
        assert _rows(out) == _rows(t)
        outs.append((tmp_path / f"{name}.out").read_bytes())
    assert outs[0] == outs[1] and outs[0]
    if kind == "text":
        with pytest.raises(ValueError, match="one column"):
            tbsink.TextSinkBatchOp(file_path=str(tmp_path / "x")).link_from(
                tbsrc.MemSourceBatchOp(tt.add_column("u", list(range(40)))))


def _stream_sources(kind, path, mods):
    src = mods
    kw = dict(batch_size=17, time_per_batch=0.5)
    if kind == "csv":
        return src.CsvSourceStreamOp(path, "id LONG, x DOUBLE, y DOUBLE",
                                     **kw)
    if kind == "libsvm":
        return src.LibSvmSourceStreamOp(path, **kw)
    return src.TextSourceStreamOp(path, **kw)


@pytest.mark.parametrize("kind", ["csv", "libsvm", "text"])
def test_stream_sources_match_the_jax_package(kind, tmp_path):
    from alink_tpu.operator.stream.source import sources as jsrc
    if kind == "libsvm":
        path = _write(tmp_path / "t.svm",
                      _libsvm_text(np.random.RandomState(4), 60))
    else:
        path = _write(tmp_path / "t.csv", _csv_text("numeric", rows=60))
    got = list(_stream_sources(kind, path, tssrc).timed_batches())
    want = list(_stream_sources(kind, path, jsrc).timed_batches())
    assert [t for t, _ in got] == [t for t, _ in want] == \
        [0.5 * k for k in range(4)]
    for (_, g), (_, w) in zip(got, want):
        _same_table(g, w)


def _stream_sink(mod, kind, path):
    if kind == "csv":
        return mod.CsvSinkStreamOp(path, field_delimiter="|")
    if kind == "libsvm":
        return mod.LibSvmSinkStreamOp(path, "label", "vec")
    return mod.TextSinkStreamOp(path)


@pytest.mark.parametrize("kind", ["csv", "libsvm", "text"])
def test_stream_sinks_write_the_jax_packages_files(kind, tmp_path):
    from alink_tpu.operator.base import StreamOperator as JStream
    from alink_tpu.operator.stream.sink import sinks as jsink
    from alink_tpu.operator.stream.source import MemSourceStreamOp as JMem
    jt, tt = _table_pair("text" if kind == "text" else "sparse")
    files = []
    for mod, Mem, Stream, t, name in (
            (tssink, tssrc.MemSourceStreamOp, TStream, tt, "t"),
            (jsink, JMem, JStream, jt, "j")):
        path = str(tmp_path / f"{name}.out")
        with open(path, "w") as f:
            f.write("stale\n")
        # two runs: the second writes the file anew
        for _ in range(2):
            _stream_sink(mod, kind, path).link_from(Mem(t, batch_size=7))
            Stream.execute()
        files.append((tmp_path / f"{name}.out").read_bytes())
    assert files[0] == files[1] and b"stale" not in files[0]
    assert files[0].count(b"\n") == 40


# -- prefetch_map -----------------------------------------------------------

def _slow_square(i):
    time.sleep((i * 7919 % 5) * 1e-3)
    return i * i


def _pool_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("alink-prefetch") and t.is_alive()]


@pytest.mark.parametrize("workers", [None, 1, 2, 4, 16])
def test_prefetch_map_keeps_the_order(workers):
    kw = {} if workers is None else {"workers": workers}
    got = list(prefetch_map(iter(range(60)), _slow_square, **kw))
    assert got == [i * i for i in range(60)]
    assert not _pool_threads()


@pytest.mark.parametrize("where", ["fn", "upstream"])
@pytest.mark.parametrize("workers", [1, 3, 8])
def test_prefetch_map_raises_where_the_item_would_come(workers, where):
    def fn(i):
        if where == "fn" and i == 13:
            raise KeyError(i)
        return _slow_square(i)

    def upstream():
        for i in range(40):
            if where == "upstream" and i == 13:
                raise KeyError(i)
            yield i

    got = []
    with pytest.raises(KeyError):
        for v in prefetch_map(upstream(), fn, workers=workers):
            got.append(v)
    assert got == [i * i for i in range(13)]
    assert not _pool_threads()


def test_prefetch_map_stops_with_its_consumer():
    closed = []

    def upstream():
        try:
            for i in range(10 ** 6):
                yield i
        finally:
            closed.append(True)

    it = prefetch_map(upstream(), _slow_square, workers=4)
    assert [next(it) for _ in range(5)] == [0, 1, 4, 9, 16]
    it.close()
    assert closed == [True] and not _pool_threads()


def test_prefetch_map_order_under_contention():
    """More workers than cores and a short switch interval: any lost or
    reordered item shows in the sequence."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        workers = 4 * (os.cpu_count() or 2)
        got = list(prefetch_map(iter(range(3000)), lambda i: (i, i + 1),
                                workers=workers))
    finally:
        sys.setswitchinterval(old)
    assert got == [(i, i + 1) for i in range(3000)]



# -- the field-blocked loader ------------------------------------------------

FB_FIELDS, FB_SIZE = 4, 16


def _fieldblock_file(path, rows, seed, bad=None):
    """One-hot field-major LibSVM rows (1-based global ids) as
    ``bench.py::bench_logreg_from_disk`` writes them; ``bad`` breaks one
    row: a value other than 1, or a missing field."""
    rng = np.random.RandomState(seed)
    fb = rng.randint(0, FB_SIZE, size=(rows, FB_FIELDS)).astype(np.int32)
    y = np.where(rng.rand(rows) < 0.5, 1.0, -1.0).astype(np.float32)
    lines = []
    for r in range(rows):
        ids = fb[r] + np.arange(FB_FIELDS) * FB_SIZE + 1
        toks = [f"{j}:1" for j in ids]
        if r == rows // 2 and bad == "value":
            toks[1] = f"{ids[1]}:2"
        if r == rows // 2 and bad == "field":
            del toks[2]
        lines.append(" ".join(["1" if y[r] > 0 else "-1"] + toks))
    _write(path, "\n".join(lines) + "\n")
    return fb, y


@pytest.mark.parametrize("shards,groups,workers",
                         [(1, 1, 1), (4, 2, 2), (7, 3, 3), (16, 4, 8)])
def test_fieldblock_loader_reads_the_rows_in_order(shards, groups, workers,
                                                   tmp_path):
    from alink_tpu.native import parse_libsvm_fb16 as jfb16
    from alink_tpu_torch.io.fieldblock import load_fieldblock_libsvm
    path = str(tmp_path / "fb.svm")
    fb_true, y_true = _fieldblock_file(path, 500, shards)
    fb, labels, st = load_fieldblock_libsvm(
        path, FB_FIELDS, FB_SIZE, shards=shards, groups=groups,
        workers=workers, device="cpu")
    assert fb.dtype == torch.int32 and labels.dtype == torch.float32
    assert np.array_equal(fb.numpy(), fb_true)
    assert labels.numpy().tobytes() == y_true.tobytes()
    with open(path, "rb") as f:
        want = jfb16(f.read(), FB_FIELDS, FB_SIZE, 1)
    assert want is not None
    assert labels.numpy().tobytes() == want[0].tobytes()
    assert np.array_equal(fb.numpy(), want[1].astype(np.int32))
    assert (st["shards"], st["workers"]) == (shards, workers)
    assert st["groups"] == -(-shards // -(-shards // groups))
    assert all(st[k] >= 0.0 for k in ("read_s", "parse_s", "copy_s",
                                      "rp_wall_s"))


@pytest.mark.parametrize("bad", ["value", "field"])
def test_fieldblock_loader_refuses_rows_that_are_not_field_blocked(
        bad, tmp_path):
    from alink_tpu_torch.io.fieldblock import load_fieldblock_libsvm
    path = str(tmp_path / "fb.svm")
    _fieldblock_file(path, 64, 0, bad=bad)
    with pytest.raises(ValueError, match="not one-hot field-major"):
        load_fieldblock_libsvm(path, FB_FIELDS, FB_SIZE, shards=4,
                               groups=2, workers=2, device="cpu")


def test_fieldblock_loader_defaults_to_the_card(tmp_path, monkeypatch):
    from alink_tpu_torch.io.fieldblock import load_fieldblock_libsvm
    path = str(tmp_path / "fb.svm")
    _fieldblock_file(path, 16, 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_fieldblock_libsvm(path, FB_FIELDS, FB_SIZE)

# -- extract_design's native fast path --------------------------------------

def _literals(case, rng, n=50):
    out = []
    for i in range(n):
        k = rng.randint(1, 7)
        idx = np.sort(rng.choice(40, k, replace=False))
        if case == "unsorted":
            idx = idx[::-1]
        vals = [NUMS[rng.randint(len(NUMS))] for _ in range(k)]
        sep = "," if case == "comma" else " "
        body = sep.join(f"{j}:{v}" for j, v in zip(idx, vals))
        out.append(f"$45${body}" if case in ("sized", "unsorted")
                   or (case == "mixed" and i % 2) else body)
    return out


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("vector_size", [None, 64])
@pytest.mark.parametrize("case", ["sized", "unsized", "comma", "mixed",
                                  "unsorted"])
def test_extract_design_fast_path_is_the_jax_packages(case, vector_size,
                                                      dtype):
    from alink_tpu.common.mtable import MTable as JMTable
    from alink_tpu.operator.common.dataproc import feature_extract as jfe
    vals = np.array(_literals(case, np.random.RandomState(len(case))),
                    object)
    got = tfe.extract_design(TMTable({"v": vals}, "v STRING"), None, "v",
                             dtype, vector_size)
    want = jfe.extract_design(JMTable({"v": vals}, "v STRING"), None, "v",
                              dtype, vector_size)
    assert got["kind"] == want["kind"] == "sparse"
    assert got["dim"] == want["dim"]
    for k in ("idx", "val"):
        assert got[k].dtype == want[k].dtype
        assert got[k].tobytes() == want[k].tobytes()
    # the per-row parse of the same literals (a column of vectors)
    rows = tfe.extract_design(
        TMTable({"v": np.array([tfe.VectorUtil.parse(v) for v in vals],
                               object)}, "v VECTOR"), None, "v", dtype,
        vector_size)
    assert rows["dim"] == got["dim"]
    if case == "unsorted":
        # the per-row parse sorts a literal's entries: the same entries
        # in another order
        def pairs(d, i, k):
            return list(zip(d["idx"][i, :k].tolist(),
                            [x.tobytes() for x in d["val"][i, :k]]))

        for i, v in enumerate(vals):
            k = v.count(":")
            assert sorted(pairs(got, i, k)) == pairs(rows, i, k)
            assert k < 2 or pairs(got, i, k) != pairs(rows, i, k)
    else:
        assert rows["idx"].tobytes() == got["idx"].tobytes()
        assert rows["val"].tobytes() == got["val"].tobytes()


def test_fast_path_leaves_what_it_cannot_read_to_the_per_row_parse():
    """A blank value collapses a row, and a ``$`` that does not open its
    literal would be dropped by the native parser: the per-row parse
    reads such columns (or refuses them)."""
    ok = ["$5$0:1 2:3", "1:2"]
    for vals, want in (([" $5$0:1 2:3", "1:2"], ok), (["", "1:2"], None)):
        col = np.array(vals, object)
        got = tfe.extract_design(TMTable({"v": col}, "v STRING"), None, "v")
        if want is None:
            assert got["idx"].shape[0] == 2
            continue
        ref = tfe.extract_design(TMTable({"v": np.array(want, object)},
                                         "v STRING"), None, "v")
        for k in ("idx", "val"):
            assert got[k].tobytes() == ref[k].tobytes()
    with pytest.raises(ValueError):
        tfe.extract_design(TMTable({"v": np.array(["0:1 $5$2:3"], object)},
                                   "v STRING"), None, "v")


# -- a LibSVM file trained by L-BFGS ---------------------------------------

@pytest.fixture(scope="module")
def jsid():
    from alink_tpu.common.mlenv import MLEnvironment, MLEnvironmentFactory
    sid = MLEnvironmentFactory.register(
        MLEnvironment(parallelism=1, devices=jax.devices()[:1]))
    yield sid
    MLEnvironmentFactory.remove(sid)


def _criteo_table(n=400, dim=1000, nnz=8, seed=0):
    """Criteo-shape rows at a small size: ``nnz`` distinct one-hot slots
    of ``dim`` a row, labels from a seeded sparse true model."""
    rng = np.random.RandomState(seed)
    w = rng.randn(dim) * (rng.rand(dim) < 0.2)
    vecs = np.empty(n, object)
    y = np.empty(n)
    for i in range(n):
        ix = np.sort(rng.choice(dim, nnz, replace=False))
        vecs[i] = TSparse(dim, ix, np.ones(nnz))
        y[i] = float(rng.rand() < 1.0 / (1.0 + np.exp(-w[ix].sum())))
    return TMTable({"label": y, "features": vecs},
                   "label DOUBLE, features SPARSE_VECTOR")


def test_libsvm_file_trains_to_the_jax_package(tmp_path, jsid):
    from alink_tpu.operator.batch.classification.linear import \
        LogisticRegressionTrainBatchOp as JTrain
    from alink_tpu.operator.batch.source import \
        LibSvmSourceBatchOp as JLibSvm
    from alink_tpu.operator.common.linear.base import \
        LinearModelDataConverter as JConverter
    from alink_tpu_torch.operator.batch.classification import \
        LogisticRegressionTrainBatchOp as TTrain
    from alink_tpu_torch.operator.common.linear.base import \
        LinearModelDataConverter as TConverter
    table = _criteo_table()
    path = str(tmp_path / "criteo.svm")
    tbsink.LibSvmSinkBatchOp(file_path=path, label_col="label",
                             vector_col="features").link_from(
        tbsrc.MemSourceBatchOp(table))
    p = dict(vector_col="features", label_col="label", max_iter=10,
             epsilon=0.0, l2=1e-3)
    src = tbsrc.LibSvmSourceBatchOp(file_path=path, vector_size=1000)
    _same_table(src.get_output_table(), table)
    top = TTrain(device="cpu", dtype=torch.float64, **p).link_from(src)
    mem = TTrain(device="cpu", dtype=torch.float64, **p).link_from(
        tbsrc.MemSourceBatchOp(table))
    jop = JTrain(ml_environment_id=jsid, **p).link_from(
        JLibSvm(file_path=path, vector_size=1000, ml_environment_id=jsid))
    tm = TConverter.load_table(top.get_output_table())
    jm = JConverter.load_table(jop.get_output_table())
    assert tm.coef.tobytes() == TConverter.load_table(
        mem.get_output_table()).coef.tobytes()
    np.testing.assert_allclose(tm.coef, jm.coef, rtol=1e-10, atol=1e-12)
    loss = np.asarray(top.get_side_output(0).get_output_table().col("loss"))
    assert len(loss) == 10 and loss[-1] < loss[0]
