"""Stream sink operators.

Counterpart: ``alink_tpu/operator/stream/sink/sinks.py``. Ported:
``BaseSinkStreamOp``, ``CollectSinkStreamOp`` (the in-memory sink that
``StreamOperator.execute()`` drains into) and the file sinks
``CsvSinkStreamOp``, ``LibSvmSinkStreamOp`` and ``TextSinkStreamOp``,
which write the first micro-batch of a run and append the others, and
``CheckpointSinkStreamOp``, the durable sink of ``common/checkpoint.py``
snapshots. The database sinks: ``DBSinkStreamOp`` appends every
micro-batch to a ``BaseDB`` table (``io/db.py``),
``JdbcRetractSinkStreamOp`` upserts by key (delete then insert a
micro-batch), ``MySqlSinkStreamOp`` is the first over MySQL. The Kafka
sink is in ``io/kafka.py``.
"""

from __future__ import annotations

from typing import List, Optional

from ....common.checkpoint import (checkpoint_tag, latest_checkpoint,
                                   load_checkpoint, save_checkpoint)
from ....common.mtable import MTable
from ....common.params import ParamInfo, Params
from ....common.types import TableSchema
from ....io.csv import format_csv_rows, format_libsvm_rows
from ...base import StreamOperator


class BaseSinkStreamOp(StreamOperator):
    def _consume(self, mt: MTable):  # pragma: no cover - interface
        raise NotImplementedError

    def link_from(self, in_op: StreamOperator) -> "BaseSinkStreamOp":
        try:
            self._schema = in_op.get_schema()
        except RuntimeError:
            self._schema = None  # upstream schema data-dependent

        self._stream_fn = in_op.timed_batches
        self._sinks.append(self._consume)
        return self._register()


class CollectSinkStreamOp(BaseSinkStreamOp):
    """Collect every micro-batch into one host table."""

    def __init__(self, params: Optional[Params] = None, **kwargs):
        super().__init__(params, **kwargs)
        self._batches: List[MTable] = []

    def _consume(self, mt: MTable):
        self._batches.append(mt)

    def get_and_remove_values(self) -> Optional[MTable]:
        out = None
        for mt in self._batches:
            out = mt if out is None else out.concat_rows(mt)
        self._batches = []
        return out


class CheckpointSinkStreamOp(BaseSinkStreamOp):
    """Durable generic sink: micro-batches land as atomic, checksummed
    checkpoints with bounded retention (``common/checkpoint.py``).

    Point it at any stream — most usefully a model-snapshot stream (the
    FTRL trainer's output), which makes the newest complete model survive
    a process kill: a restarted job reloads it with
    ``CheckpointSinkStreamOp.load_latest(dir)`` and hands it to the
    predictor as the warm start. All-numeric tables persist as ``.npy``
    column payloads; tables with string or vector columns persist through
    the MTable JSON row codec (exact round trip either way). The tag
    sequence continues across restarts.
    """

    def __init__(self, checkpoint_dir: str, every: int = 1,
                 keep_last: int = 5, params: Optional[Params] = None,
                 **kwargs):
        super().__init__(params, **kwargs)
        if int(every) < 1 or int(keep_last) < 1:
            raise ValueError("every and keep_last must be >= 1")
        self.checkpoint_dir = checkpoint_dir
        self.every = int(every)
        self.keep_last = int(keep_last)
        self._seen = 0

    def link_from(self, in_op):
        # continue the tag sequence across restarts: starting over at 1
        # would make tag-ordered retention delete every NEW snapshot
        # while load_latest kept serving the previous run's data
        latest = latest_checkpoint(self.checkpoint_dir, validate=False)
        self._seen = checkpoint_tag(latest) if latest is not None else 0
        return super().link_from(in_op)

    def _consume(self, mt: MTable):
        self._seen += 1
        if (self._seen - 1) % self.every:
            return
        cols = {name: mt.col(name) for name in mt.col_names}
        if all(c.dtype != object and c.dtype.kind in "biuf"
               for c in cols.values()):
            payload = cols
            meta = {"mode": "arrays", "schema": mt.schema.to_spec(),
                    "batch_index": self._seen}
        else:
            payload = {}
            meta = {"mode": "json_rows", "table": mt.to_json_rows(),
                    "batch_index": self._seen}
        save_checkpoint(self.checkpoint_dir, self._seen, payload, meta=meta,
                        scope="stream_sink", keep_last=self.keep_last)

    @staticmethod
    def load_latest(checkpoint_dir: str) -> Optional[MTable]:
        """Newest valid persisted batch, or None (corrupted snapshots are
        skipped: the crash-during-write recovery path)."""
        path = latest_checkpoint(checkpoint_dir)
        if path is None:
            return None
        # already checksummed by latest_checkpoint
        payload, meta = load_checkpoint(path, scope="stream_sink",
                                        validate=False)
        if meta.get("mode") == "arrays":
            schema = TableSchema.parse(meta["schema"])
            return MTable({n: payload[n] for n in schema.names}, schema)
        return MTable.from_json_rows(meta["table"])


class _FileSinkStreamOp(BaseSinkStreamOp):
    """A file sink: the first micro-batch after ``link_from`` truncates
    the file, the later ones append."""

    def __init__(self, file_path: str, params=None, **kwargs):
        super().__init__(params, **kwargs)
        self.file_path = file_path
        self._started = False

    def link_from(self, in_op):
        self._started = False
        return super().link_from(in_op)

    def _format(self, mt: MTable) -> str:  # pragma: no cover - interface
        raise NotImplementedError

    def _consume(self, mt: MTable):
        with open(self.file_path, "a" if self._started else "w") as f:
            f.write(self._format(mt))
        self._started = True


class CsvSinkStreamOp(_FileSinkStreamOp):
    """reference: stream/sink/CsvSinkStreamOp (append a micro-batch)."""

    def __init__(self, file_path: str, field_delimiter: str = ",",
                 params=None, **kwargs):
        super().__init__(file_path, params, **kwargs)
        self.field_delimiter = field_delimiter

    def _format(self, mt: MTable) -> str:
        return format_csv_rows(mt, self.field_delimiter)


class LibSvmSinkStreamOp(_FileSinkStreamOp):
    """reference: stream/sink/LibSvmSinkStreamOp."""

    def __init__(self, file_path: str, label_col: str, vector_col: str,
                 params=None, **kwargs):
        super().__init__(file_path, params, **kwargs)
        self.label_col = label_col
        self.vector_col = vector_col

    def _format(self, mt: MTable) -> str:
        return format_libsvm_rows(mt, self.label_col, self.vector_col)


class TextSinkStreamOp(_FileSinkStreamOp):
    """reference: stream/sink/TextSinkStreamOp (its first column, a line
    a value)."""

    def _format(self, mt: MTable) -> str:
        return "".join(f"{v}\n" for v in mt.col(mt.col_names[0]))


from ....io.db import HasDB as _HasDB


class DBSinkStreamOp(_HasDB, BaseSinkStreamOp):
    """Append every micro-batch into a DB table
    (reference: stream/sink/DBSinkStreamOp.java)."""
    OUTPUT_TABLE_NAME = ParamInfo("output_table_name", str, optional=False)

    def _consume(self, mt: MTable):
        self._db().write_table(self.params._m["output_table_name"], mt,
                               append=True)


class JdbcRetractSinkStreamOp(DBSinkStreamOp):
    """Upsert sink: rows replace earlier rows with the same key
    (reference: stream/sink/JdbcRetractSinkStreamOp.java — there Flink
    retract-stream semantics; here delete-then-insert per micro-batch)."""
    KEY_COLS = ParamInfo("key_cols", list, "primary-key columns",
                         optional=False)

    def _consume(self, mt: MTable):
        db = self._db()
        table = self.params._m["output_table_name"]
        keys = self.params._m["key_cols"]
        if not db.has_table(table):
            db.create_table(table, mt.schema)
        kidx = [mt.col_names.index(k) for k in keys]
        # last write wins within a micro-batch too (upsert contract)
        last = {}
        for r in mt.to_rows():
            last[tuple(_pyv(r[i]) for i in kidx)] = r
        where = " AND ".join(f"{k} = ?" for k in keys)
        non_null = [kv for kv in last if all(v is not None for v in kv)]
        if non_null:
            db.executemany(f"DELETE FROM {table} WHERE {where}", non_null)
        for kv in last:
            if any(v is None for v in kv):  # NULL never matches '= ?'
                clause = " AND ".join(
                    f"{k} IS NULL" if v is None else f"{k} = ?"
                    for k, v in zip(keys, kv))
                db.execute(f"DELETE FROM {table} WHERE {clause}",
                           [v for v in kv if v is not None])
        db.write_table(table, MTable(list(last.values()), mt.schema),
                       append=True)


def _pyv(v):
    return v.item() if hasattr(v, "item") else v


from ....io.db import HasMySqlDB as _HasMySqlDB


class MySqlSinkStreamOp(_HasMySqlDB, DBSinkStreamOp):
    """reference: stream/sink/MySqlSinkStreamOp.java"""
