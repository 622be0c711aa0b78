"""Slice 25 of the port: the IO connectors (``io/db.py``, ``io/hive.py``,
``io/hive_warehouse.py``, ``io/kafka.py``, ``io/directreader.py``,
``io/bucketing.py``, the http branch of ``io/csv.py``) and the
generator, DB and MySQL sources and sinks, on the CPU against the JAX
package.

Each runs the JAX connector and the port's on the same seeded table
against in-process stand-ins (stdlib ``sqlite3`` files, a warehouse
directory under ``tmp_path``, ``FakeKafka``, a patched ``urlopen``: no
socket is opened). Host code, held exactly: the same tables, the same
files byte for byte, the same messages.
"""

import io as _io
import os

import numpy as np
import pytest

from alink_tpu.common.mtable import MTable as JT
from alink_tpu.io import bucketing as jbk
from alink_tpu.io import db as jdb
from alink_tpu.io import directreader as jdr
from alink_tpu.io import hive as jhive
from alink_tpu.io import kafka as jkafka
from alink_tpu.operator.base import TableSourceBatchOp as JSrc
from alink_tpu.operator.batch.sink import sinks as jbsink
from alink_tpu.operator.batch.source import sources as jbsrc
from alink_tpu.operator.stream.sink import sinks as jssink
from alink_tpu.operator.stream.source import sources as jssrc
from alink_tpu.operator.stream.source.sources import \
    MemSourceStreamOp as JMemS
from alink_tpu.operator.stream.sink.sinks import \
    CollectSinkStreamOp as JCollect
from alink_tpu.operator.base import StreamOperator as JStream
from alink_tpu_torch.common.mtable import MTable as TT
from alink_tpu_torch.io import bucketing as tbk
from alink_tpu_torch.io import csv as tcsv
from alink_tpu_torch.io import db as tdb
from alink_tpu_torch.io import directreader as tdr
from alink_tpu_torch.io import hive as thive
from alink_tpu_torch.io import kafka as tkafka
from alink_tpu_torch.operator.base import StreamOperator as TStream
from alink_tpu_torch.operator.base import TableSourceBatchOp as TSrc
from alink_tpu_torch.operator.batch.sink import sinks as tbsink
from alink_tpu_torch.operator.batch.source import sources as tbsrc
from alink_tpu_torch.operator.stream.sink import sinks as tssink
from alink_tpu_torch.operator.stream.sink.sinks import \
    CollectSinkStreamOp as TCollect
from alink_tpu_torch.operator.stream.source import sources as tssrc
from alink_tpu_torch.operator.stream.source.sources import \
    MemSourceStreamOp as TMemS

SCHEMA = "id LONG, x DOUBLE, s STRING, ok BOOLEAN"


def _rows(n=30, seed=0):
    rng = np.random.RandomState(seed)
    words = ["a", "b\x01c", "d\\Ne", "new\nline", None, "plain"]
    return [(i, float(rng.randn()), words[rng.randint(0, len(words))],
             bool(rng.rand() < 0.5)) for i in range(n)]


def _cell(v):
    if isinstance(v, (float, np.floating)):
        return ("f", np.float64(v).tobytes())
    if isinstance(v, (bool, np.bool_)):
        return ("o", str(bool(v)))
    if isinstance(v, (int, np.integer)):
        return ("o", str(int(v)))
    return ("o", str(v))


def same(got, want):
    assert got.col_names == want.col_names
    assert list(got.schema.types) == list(want.schema.types)
    assert [tuple(map(_cell, r)) for r in got.to_rows()] == \
        [tuple(map(_cell, r)) for r in want.to_rows()]


def test_generator_sources_equal_the_jax_packages():
    same(tbsrc.NumSeqSourceBatchOp(3, 17).get_output_table(),
         jbsrc.NumSeqSourceBatchOp(3, 17).get_output_table())
    same(tbsrc.RandomTableSourceBatchOp(50, 3, seed=4).get_output_table(),
         jbsrc.RandomTableSourceBatchOp(50, 3, seed=4).get_output_table())
    for t, j in ((tssrc.NumSeqSourceStreamOp(0, 40, batch_size=16),
                  jssrc.NumSeqSourceStreamOp(0, 40, batch_size=16)),
                 (tssrc.RandomTableSourceStreamOp(70, 2, seed=9,
                                                  batch_size=32),
                  jssrc.RandomTableSourceStreamOp(70, 2, seed=9,
                                                  batch_size=32))):
        g, w = list(t.timed_batches()), list(j.timed_batches())
        assert [x for x, _ in g] == [x for x, _ in w] and len(g) == 3
        for (_, a), (_, b) in zip(g, w):
            same(a, b)


@pytest.fixture
def dbs(tmp_path):
    t = tdb.SqliteDB("port_db", str(tmp_path / "port.sqlite"))
    j = jdb.SqliteDB("jax_db", str(tmp_path / "jax.sqlite"))
    yield t, j
    t.close()
    j.close()


def test_db_sink_and_source_round_trip_as_there(dbs):
    t, j = dbs
    rows = _rows()
    tbsink.DBSinkBatchOp(db=t, output_table_name="tab").link_from(
        TSrc(TT(rows, SCHEMA)))
    jbsink.DBSinkBatchOp(db=j, output_table_name="tab").link_from(
        JSrc(JT(rows, SCHEMA)))
    assert t.list_table_names() == j.list_table_names() == ["tab"]
    got = tbsrc.DBSourceBatchOp(db_name="port_db", input_table_name="tab")
    want = jbsrc.DBSourceBatchOp(db_name="jax_db", input_table_name="tab")
    same(got.get_output_table(), want.get_output_table())
    q = "SELECT id, x FROM tab WHERE x > 0 ORDER BY x"
    same(tbsrc.DBSourceBatchOp(db=t, query=q).get_output_table(),
         jbsrc.DBSourceBatchOp(db=j, query=q).get_output_table())
    tbsink.DBSinkBatchOp(db=t, output_table_name="tab",
                         overwrite_sink=True).link_from(
        TSrc(TT(rows[:5], SCHEMA)))
    assert t.read_table("tab").num_rows == 5
    assert t.get_table_schema("tab").names == ["id", "x", "s", "ok"]


def test_db_stream_source_and_sinks_as_there(dbs):
    t, j = dbs
    rows = _rows(40, 1)
    t.write_table("src", TT(rows, SCHEMA))
    j.write_table("src", JT(rows, SCHEMA))
    ts = tssrc.DBSourceStreamOp(db=t, input_table_name="src", batch_size=16)
    js = jssrc.DBSourceStreamOp(db=j, input_table_name="src", batch_size=16)
    g, w = list(ts.timed_batches()), list(js.timed_batches())
    assert len(g) == len(w) == 3
    for (_, a), (_, b) in zip(g, w):
        same(a, b)
    tssink.DBSinkStreamOp(db=t, output_table_name="out").link_from(ts)
    jssink.DBSinkStreamOp(db=j, output_table_name="out").link_from(js)
    TStream.execute()
    JStream.execute()
    same(t.read_table("out"), j.read_table("out"))
    upd = [(r[0] % 7, r[1], r[2], r[3]) for r in rows]
    for db, retract, mem, ex in (
            (t, tssink.JdbcRetractSinkStreamOp, TMemS, TStream),
            (j, jssink.JdbcRetractSinkStreamOp, JMemS, JStream)):
        retract(db=db, output_table_name="up", key_cols=["id"]).link_from(
            mem(upd, SCHEMA, batch_size=9))
        ex.execute()
    same(t.query("SELECT * FROM up ORDER BY id"),
         j.query("SELECT * FROM up ORDER BY id"))
    assert t.read_table("up").num_rows == 7


def test_mysql_and_hive_servers_need_their_drivers(monkeypatch):
    import builtins
    real = builtins.__import__

    def no_drivers(name, *a, **k):
        if name.split(".")[0] in ("mysql", "pymysql", "MySQLdb", "pyhive",
                                  "kafka"):
            raise ImportError(f"no module named {name}")
        return real(name, *a, **k)
    monkeypatch.setattr(builtins, "__import__", no_drivers)
    import importlib
    monkeypatch.setattr(importlib, "import_module",
                        lambda n, *a: no_drivers(n))
    src = tbsrc.MySqlSourceBatchOp(host="h", db_name="d", username="u",
                                   password="p", input_table_name="t")
    with pytest.raises(ImportError, match="MySQL DB-API driver"):
        src.get_output_table()
    with pytest.raises(ImportError, match="pyhive"):
        thive.HiveSourceBatchOp(host="h", input_table_name="t").link_from()
    with pytest.raises(ImportError, match="no Kafka client"):
        tkafka.KafkaSourceStreamOp(topic="t", schema_str="a LONG")
    assert tdb.MySqlDB.PARAM_STYLE == "%s" and tdb.DerbyDB is tdb.SqliteDB


def _files(root):
    out = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def test_hive_warehouse_writes_the_same_files_and_reads_back(tmp_path):
    rows = _rows(40, 2)
    wt, wj = str(tmp_path / "port"), str(tmp_path / "jax")
    for day, part in (("20190729", rows[:25]), ("20190730", rows[25:])):
        for wh, sink, T, src in ((wt, thive.HiveSinkBatchOp, TT, TSrc),
                                 (wj, jhive.HiveSinkBatchOp, JT, JSrc)):
            sink(warehouse_dir=wh, output_table_name="ev", db_name="ads",
                 partition=f"ds={day}").link_from(src(T(part, SCHEMA)))
    assert _files(wt) == _files(wj) and len(_files(wt)) == 3
    for parts in (None, "ds=20190730", "ds=20190729,ds=20190730"):
        kw = dict(warehouse_dir=wt, input_table_name="ev", db_name="ads")
        kj = dict(kw, warehouse_dir=wj)
        if parts:
            kw["partitions"] = kj["partitions"] = parts
        got = thive.HiveSourceBatchOp(**kw).link_from()
        want = jhive.HiveSourceBatchOp(**kj).link_from()
        same(got.get_output_table(), want.get_output_table())
    one = thive.HiveSourceBatchOp(warehouse_dir=wt, input_table_name="ev",
                                  db_name="ads", partitions="ds=20190729")
    back = one.link_from().get_output_table()
    assert back.num_rows == 25 and set(back.col("ds")) == {"20190729"}
    same(back.select(["id", "x", "s", "ok"]), JT(rows[:25], SCHEMA))
    ts = thive.HiveSourceStreamOp(warehouse_dir=wt, input_table_name="ev",
                                  db_name="ads", batch_size=16)
    js = jhive.HiveSourceStreamOp(warehouse_dir=wj, input_table_name="ev",
                                  db_name="ads", batch_size=16)
    g, w = list(ts.timed_batches()), list(js.timed_batches())
    assert len(g) == len(w) == 3
    for (_, a), (_, b) in zip(g, w):
        same(a, b)
    with pytest.raises(ValueError, match="schema mismatch"):
        thive.HiveSinkBatchOp(warehouse_dir=wt, output_table_name="ev",
                              db_name="ads", partition="ds=1").link_from(
            TSrc(TT([(1,)], "id LONG")))


@pytest.mark.parametrize("fmt", ["json", "csv"])
def test_kafka_source_and_sink_through_fake_kafka(fmt):
    rows = [(i, float(i) / 4, f"w{i}") for i in range(25)]
    schema = "id LONG, x DOUBLE, s STRING"
    out = {}
    for mod, mem, ex, collect in ((tkafka, TMemS, TStream, TCollect),
                                  (jkafka, JMemS, JStream, JCollect)):
        bus = mod.FakeKafka()
        mod.KafkaSinkStreamOp(topic="in", format=fmt, producer=bus) \
            .link_from(mem(rows, schema, batch_size=10))
        ex.execute()
        msgs = list(bus.topics["in"])
        src = mod.KafkaSourceStreamOp(topic="in", format=fmt,
                                      schema_str=schema, consumer=bus)
        sink = collect().link_from(src)
        ex.execute()
        out[mod.__name__] = (msgs, sink.get_and_remove_values())
    (tm, tv), (jm, jv) = out.values()
    assert tm == jm and len(tm) == 25
    same(tv, jv)


def test_direct_reader_memory_and_db_policies(tmp_path, monkeypatch):
    rows = _rows(12, 3)
    t = tdb.SqliteDB("port_bridge", str(tmp_path / "b.sqlite"))
    j = jdb.SqliteDB("jax_bridge", str(tmp_path / "bj.sqlite"))
    op_t, op_j = TSrc(TT(rows, SCHEMA)), JSrc(JT(rows, SCHEMA))
    assert tdr.DirectReader.collect(op_t).read_mtable() is \
        op_t.get_output_table()
    for store, name in ((tdr.DirectReaderPropertiesStore, "port_bridge"),
                        (jdr.DirectReaderPropertiesStore, "jax_bridge")):
        store.set_properties({"direct.reader.policy": "db",
                              "direct.reader.db.name": name})
    try:
        bt = tdr.DirectReader.collect(op_t)
        bj = jdr.DirectReader.collect(op_j)
    finally:
        tdr.DirectReaderPropertiesStore.set_properties({})
        jdr.DirectReaderPropertiesStore.set_properties({})
    assert isinstance(bt, tdr.DbDataBridge)
    same(bt.read_mtable(), bj.read_mtable())
    keep = lambda r: r[1] > 0   # noqa: E731
    assert [tuple(map(_cell, r)) for r in bt.read(keep)] == \
        [tuple(map(_cell, r)) for r in bj.read(keep)]
    monkeypatch.setenv("ALINK_DIRECT_READER_POLICY", "nope")
    with pytest.raises(ValueError, match="unknown direct reader policy"):
        tdr.DirectReader.collect(op_t)
    t.close()
    j.close()


@pytest.mark.parametrize("mode", ["ruler", "size", "db"])
def test_table_bucketing_sink_as_there(tmp_path, mode):
    schema_t = TT([], "id LONG, x DOUBLE").schema
    schema_j = JT([], "id LONG, x DOUBLE").schema
    rows = [(i, float(i) * 0.5) for i in range(23)]
    res = {}
    for name, mod, schema in (("port", tbk, schema_t), ("jax", jbk, schema_j)):
        kw = {}
        if mode == "db":
            kw["db"] = (tdb if name == "port" else jdb).SqliteDB(
                f"{name}_bk", str(tmp_path / f"{name}.sqlite"))
            kw["batch_size"] = 5
        else:
            kw["base_dir"] = str(tmp_path / name)
            if mode == "size":
                kw["batch_size"] = 6
        sink = mod.TableBucketingSink("b", schema, **kw)
        if mode == "ruler":
            for i, r in enumerate(rows):
                sink.invoke((i % 3, len(range(i % 3, 23, 3))) + r)
        else:
            sink.write_table((TT if name == "port" else JT)(
                rows, "id LONG, x DOUBLE"))
        sink.close()
        names = sink.bucket_names()
        if mode == "db":
            res[name] = (names, [kw["db"].read_table(n).to_rows()
                                 for n in names])
        else:
            res[name] = (names, _files(kw["base_dir"]))
    assert res["port"][0] == res["jax"][0] and len(res["port"][0]) >= 3
    if mode == "db":
        got = [r for tab in res["port"][1] for r in tab]
        assert [tuple(map(_cell, r)) for r in got] == \
            [tuple(map(_cell, r)) for tab in res["jax"][1] for r in tab]
        assert len(got) == 23
    else:
        assert res["port"][1] == res["jax"][1]


def test_csv_source_reads_http_through_urlopen(monkeypatch):
    body = b"h1,h2\n1,2.5\n3,4.5\n"
    seen = []

    class Resp(_io.BytesIO):
        pass

    def fake_urlopen(url):
        seen.append(url)
        return Resp(body)
    monkeypatch.setattr(tcsv, "urlopen", fake_urlopen)
    url = "http://example.invalid/data.csv"
    got = tbsrc.CsvSourceBatchOp(file_path=url, schema_str="a LONG, b DOUBLE",
                                 ignore_first_line=True).get_output_table()
    assert seen == [url] and got.to_rows() == [(1, 2.5), (3, 4.5)]
    with pytest.raises(ValueError, match="sharded reads of http"):
        tcsv.read_csv(url, got.schema, shard=(0, 2))
    assert tcsv.read_csv("https://x.invalid/a.csv", got.schema,
                         ignore_first_line=True, shard=(0, 1)).num_rows == 2


def test_chip_smoke_phase_25_rehearses_on_the_cpu():
    """``chip_smoke.py`` phase 25 on the CPU at small sizes: every gate
    that does not count a card's launches holds (the connectors' round
    trips, the format ops, the bitwise model and snapshot routes, the
    numpy counts, the lazy hooks, the bridge and the buckets)."""
    import torch

    import chip_smoke
    from alink_tpu_torch.kernels import fm, ftrl, linear, rows, serve, \
        tree_hist
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = chip_smoke.phase_connectors(
            (serve, linear, ftrl, tree_hist, rows, fm), "cpu", dev="cpu",
            sizes=dict(rows=2_000, f64_rows=400, f64_steps=2, lr_iter=3,
                       serve_rows=256, kafka_rows=1_024, kafka_batch=256,
                       retail=(4_000, 800, 11.0), sequences=(300, 20),
                       bucket_rows=500))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert out["kafka"]["snapshots"] == 2
    assert out["kafka"]["messages_out"] == 1_024
    assert out["association"]["itemsets"] > 10
    assert out["bridge"]["bucket_rows"] == 500
    assert not any(out["launches"].values())      # no kernel on the CPU
