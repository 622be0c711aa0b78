"""Hive connector.

Counterpart: ``alink_tpu/io/hive.py``, the re-design of
connectors/connector-hive (HiveDB.java, HiveBatchSource.java,
Hive{Source,Sink}BatchOp, HiveSourceStreamOp, HiveSourceParams /
HiveSinkParams). Two paths:

- **Warehouse files** (``warehouse_dir=``): partitioned ``k=v`` trees
  of Hive text read with partition pruning and written with static
  partition specs (``io/hive_warehouse.py``), no server.
- **Live HiveServer2** (``host=``) over DB-API: ``HiveDB`` binds to
  ``pyhive`` at its first connection and raises a clear ``ImportError``
  without it; the ``JdbcDB`` query and write code is reused.

Host only; none of these ops takes a device.
"""

from __future__ import annotations

from ..common.params import ParamInfo
from ..common.types import TableSchema
from ..operator.base import BatchOperator
from ..operator.batch.sink.sinks import DBSinkBatchOp
from ..operator.batch.source.sources import DBSourceBatchOp
from ..operator.stream.source.sources import BoundedTableStreamSource
from .db import JdbcDB
from .hive_warehouse import HiveWarehouse


class HiveDB(JdbcDB):
    """reference: connectors/connector-hive HiveDB.java (live-server half)"""

    PARAM_STYLE = "%s"

    def __init__(self, name: str, host: str, port: int = 10000,
                 database: str = "default", username: str = None):
        def factory():
            try:
                from pyhive import hive
            except ImportError as e:
                raise ImportError(
                    "HiveDB needs pyhive (pip install 'pyhive[hive]'), "
                    "which is not installed") from e
            return hive.Connection(host=host, port=port, database=database,
                                   username=username)

        super().__init__(name, factory)
        self.database = database

    def list_table_names(self):
        return [str(r[0]) for r in self.query("SHOW TABLES").to_rows()]


class _HasHiveDB:
    """Hive connection/location params shared by source and sink.

    ``warehouse_dir`` selects the serverless warehouse-layout path;
    ``host`` selects live HiveServer2 (reference HiveDBParams)."""
    WAREHOUSE_DIR = ParamInfo("warehouse_dir", str,
                              "hive warehouse root (serverless file path)")
    HOST = ParamInfo("host", str, "HiveServer2 host (live-server path)")
    PORT = ParamInfo("port", int, default=10000)
    DB_NAME = ParamInfo("db_name", str, default="default")
    USERNAME = ParamInfo("username", str)

    def _warehouse(self):
        wd = self.params._m.get("warehouse_dir")
        return HiveWarehouse(wd) if wd else None

    def _make_db(self):
        p = self.params._m
        if not p.get("host"):
            raise ValueError("Hive op needs warehouse_dir= (file path) or "
                             "host= (HiveServer2)")
        return HiveDB(f"hive:{p.get('db_name', 'default')}", p["host"],
                      int(p.get("port", 10000)),
                      p.get("db_name", "default"), p.get("username"))

    def _warehouse_read(self):
        wh = self._warehouse()
        p = self.params._m
        if p.get("query"):
            raise ValueError("query needs the live-server path (host=); the "
                             "warehouse_dir path reads whole tables — use "
                             "partitions= to prune, or a downstream Select")
        schema = (TableSchema.parse(p["schema_str"])
                  if p.get("schema_str") else None)
        return wh.read_table(p["input_table_name"],
                             db=p.get("db_name", "default"), schema=schema,
                             partitions=p.get("partitions"))

    def _server_read(self):
        """Live-server read honoring ``query`` (free-form SELECT, like
        DBSourceBatchOp) or ``partitions`` as a pushed-down WHERE (comma =
        OR of alternatives, slash = AND of levels). ``schema_str`` is
        rejected here — the server's schema is authoritative."""
        from .hive_warehouse import parse_partitions_param
        p = self.params._m
        if p.get("schema_str"):
            raise ValueError("schema_str only applies to the warehouse_dir "
                             "path; the live server defines the schema")
        db = self._make_db()
        if p.get("query"):
            if p.get("partitions"):
                raise ValueError("query and partitions are mutually "
                                 "exclusive on the live-server path")
            return db.query(p["query"])
        alts = parse_partitions_param(p.get("partitions"))
        if not alts:
            return db.read_table(p["input_table_name"])
        for alt in alts:
            for k in alt:
                if not k.replace("_", "").isalnum():
                    raise ValueError(f"bad partition column name: {k!r}")
        ors = " OR ".join(
            "(" + " AND ".join(f"{k}=?" for k in alt) + ")" for alt in alts)
        vals = [v for alt in alts for v in alt.values()]
        return db.query(
            f"SELECT * FROM {p['input_table_name']} WHERE {ors}", vals)


class HiveSourceBatchOp(_HasHiveDB, DBSourceBatchOp):
    """reference: connector-hive HiveSourceBatchOp + HiveBatchSource.

    ``partitions`` prunes: "/" separates levels, "," separates alternative
    specs (HiveSourceParams.PARTITIONS: ``ds=20190729/dt=12,ds=20190730``).
    Partition columns come back as appended STRING columns."""

    PARTITIONS = ParamInfo("partitions", str, "partition pruning spec")
    SCHEMA_STR = ParamInfo("schema_str", str,
                           "'col TYPE, ...' (else the table's schema sidecar)")

    def link_from(self, *inputs) -> "HiveSourceBatchOp":
        if self._warehouse() is None:
            self.set_output_table(self._server_read())
            return self
        self.set_output_table(self._warehouse_read())
        return self


class HiveSourceStreamOp(_HasHiveDB, BoundedTableStreamSource):
    """reference: connector-hive HiveSourceStreamOp — the same
    partition-pruned read replayed as timed micro-batches."""

    PARTITIONS = ParamInfo("partitions", str, "partition pruning spec")
    SCHEMA_STR = ParamInfo("schema_str", str,
                           "'col TYPE, ...' (else the table's schema sidecar)")
    INPUT_TABLE_NAME = ParamInfo("input_table_name", str, optional=False)

    def _resolve(self):
        if self._table is None:
            table = (self._server_read() if self._warehouse() is None
                     else self._warehouse_read())
            self._set_table(table)
        return self._table

    def timed_batches(self):
        self._resolve()
        return super().timed_batches()

    def get_schema(self):
        self._resolve()
        return super().get_schema()


class HiveSinkBatchOp(_HasHiveDB, DBSinkBatchOp):
    """reference: connector-hive HiveSinkBatchOp.

    ``partition`` is a static-partition spec ``k=v/k2=v2``
    (HiveSinkParams.PARTITION; HiveDB.java:135-178)."""

    PARTITION = ParamInfo("partition", str, "static partition spec k=v/k2=v2")

    def link_from(self, in_op: BatchOperator) -> "HiveSinkBatchOp":
        wh = self._warehouse()
        if wh is None:
            return DBSinkBatchOp.link_from(self, in_op)
        t = in_op.get_output_table()
        p = self.params._m
        wh.write_table(p["output_table_name"], t,
                       db=p.get("db_name", "default"),
                       partition=p.get("partition"),
                       overwrite=bool(p.get("overwrite_sink", False)))
        self.set_output_table(t)
        return self
