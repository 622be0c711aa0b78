"""Data-proc batch operators.

Counterpart: ``alink_tpu/operator/batch/dataproc/__init__.py``. Ported:
``JsonValueBatchOp`` (reference batch/dataproc/JsonValueBatchOp.java)
with its JSON-path reader ``_json_path_get``. The scalers and imputer
are in ``scalers.py``. Not ported yet: the sample, split, first-N,
append-id, type-cast and shuffle ops of this module, ``indexers.py``,
``vector_ops.py`` and the format-conversion matrix (``format/``).
"""

from __future__ import annotations

from ....common.params import ParamInfo
from ....common.types import AlinkTypes
from ....params.shared import HasSelectedCol
from ...base import BatchOperator


def _json_path_get(obj, path: str):
    """Tiny JSONPath subset: $.a.b[0].c (reference JsonValueBatchOp uses
    JsonPath; only the dotted/indexed form the docs exercise is supported)."""
    import re as _re
    cur = obj
    p = path.strip()
    if p.startswith("$"):
        p = p[1:]
    for tok in _re.findall(r"\.?([^.\[\]]+)|\[(\d+)\]", p):
        name, idx = tok
        if name:
            if not isinstance(cur, dict) or name not in cur:
                raise KeyError(path)
            cur = cur[name]
        else:
            i = int(idx)
            if not isinstance(cur, (list, tuple)) or i >= len(cur):
                raise KeyError(path)
            cur = cur[i]
    return cur


class JsonValueBatchOp(BatchOperator, HasSelectedCol):
    """Extract JSON-path values from a string column into new columns
    (reference batch/dataproc/JsonValueBatchOp.java)."""
    JSON_PATH = ParamInfo("json_path", list, "JSON paths to extract",
                          optional=False, aliases=("json_paths",))
    OUTPUT_COLS = ParamInfo("output_cols", list, "output column names",
                            optional=False)
    SKIP_FAILED = ParamInfo("skip_failed", bool,
                            "emit None instead of erroring", default=False)

    def link_from(self, in_op: BatchOperator) -> "JsonValueBatchOp":
        import json as _json
        t = in_op.get_output_table()
        paths = self.get_json_path()
        outs = self.get_output_cols()
        if len(paths) != len(outs):
            raise ValueError("json_path and output_cols length mismatch")
        skip = self.get_skip_failed()
        new_cols = {o: [] for o in outs}
        for v in t.col(self.get_selected_col()):
            try:
                obj = _json.loads(v) if v is not None else None
            except ValueError:
                obj = None
            for p, o in zip(paths, outs):
                try:
                    if obj is None:
                        raise KeyError(p)
                    val = _json_path_get(obj, p)
                    new_cols[o].append(
                        val if isinstance(val, str) or val is None
                        else _json.dumps(val) if isinstance(val, (dict, list))
                        else str(val))
                except KeyError:
                    if not skip:
                        raise ValueError(
                            f"json path {p!r} failed on {v!r}") from None
                    new_cols[o].append(None)
        for o in outs:
            t = t.add_column(o, new_cols[o], AlinkTypes.STRING)
        self._output = t
        return self
