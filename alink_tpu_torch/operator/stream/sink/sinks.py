"""Stream sink operators.

Counterpart: ``alink_tpu/operator/stream/sink/sinks.py``. Ported:
``BaseSinkStreamOp``, ``CollectSinkStreamOp`` (the in-memory sink that
``StreamOperator.execute()`` drains into) and the file sinks
``CsvSinkStreamOp``, ``LibSvmSinkStreamOp`` and ``TextSinkStreamOp``,
which write the first micro-batch of a run and append the others. The
checkpoint sink waits for the durability slice (ROADMAP A4(b)), the
database sinks for A8.
"""

from __future__ import annotations

from typing import List, Optional

from ....common.mtable import MTable
from ....common.params import Params
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
