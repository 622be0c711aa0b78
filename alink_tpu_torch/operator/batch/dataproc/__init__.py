"""Data-proc batch operators (the sampling, split, id and cast family).

Counterpart: ``alink_tpu/operator/batch/dataproc/__init__.py``, the
re-design of operator/batch/dataproc/ (SampleBatchOp,
SampleWithSizeBatchOp, WeightSampleBatchOp, SplitBatchOp, FirstNBatchOp,
AppendIdBatchOp, NumericalTypeCastBatchOp, ShuffleBatchOp) and
``JsonValueBatchOp`` (reference batch/dataproc/JsonValueBatchOp.java)
with its JSON-path reader ``_json_path_get``. Every draw comes from
``np.random.RandomState(seed)`` on the host, made exactly as the JAX
package makes it, so a seed picks the same rows in both packages; none
of these ops takes a device. The scalers and imputer are in
``scalers.py``, the indexers in ``indexers.py``, the vector ops in
``vector_ops.py``. Not ported yet: the format-conversion matrix
(``format/``).
"""

from __future__ import annotations

import numpy as np

from ....common.params import ParamInfo, RangeValidator
from ....common.types import AlinkTypes
from ....params.shared import HasSeed, HasSelectedCol, HasSelectedCols
from ...base import BatchOperator


class SampleBatchOp(BatchOperator, HasSeed):
    """Bernoulli / with-replacement sampling (reference SampleBatchOp)."""
    RATIO = ParamInfo("ratio", float, optional=False,
                      validator=RangeValidator(0.0, 1.0))
    WITH_REPLACEMENT = ParamInfo("with_replacement", bool, default=False)

    def link_from(self, in_op: BatchOperator) -> "SampleBatchOp":
        t = in_op.get_output_table()
        rng = np.random.RandomState(self.get_seed())
        n = t.num_rows
        if self.get_with_replacement():
            m = int(round(self.get_ratio() * n))
            idx = rng.randint(0, n, size=m)
            self._output = t.take_rows(idx)
        else:
            mask = rng.rand(n) < self.get_ratio()
            self._output = t.filter_mask(mask)
        return self


class SampleWithSizeBatchOp(BatchOperator, HasSeed):
    """Exact-size sample (reference SampleWithSizeBatchOp)."""
    SIZE = ParamInfo("size", int, optional=False, validator=RangeValidator(0, None))
    WITH_REPLACEMENT = ParamInfo("with_replacement", bool, default=False)

    def link_from(self, in_op: BatchOperator) -> "SampleWithSizeBatchOp":
        t = in_op.get_output_table()
        rng = np.random.RandomState(self.get_seed())
        n = t.num_rows
        size = self.get_size()
        if self.get_with_replacement():
            idx = rng.randint(0, n, size=size)
        else:
            idx = rng.permutation(n)[:size]
        self._output = t.take_rows(np.sort(idx))
        return self


class WeightSampleBatchOp(BatchOperator, HasSeed):
    """Weighted sampling without replacement (reference WeightSampleBatchOp)."""
    WEIGHT_COL = ParamInfo("weight_col", str, optional=False)
    RATIO = ParamInfo("ratio", float, optional=False,
                      validator=RangeValidator(0.0, 1.0))

    def link_from(self, in_op: BatchOperator) -> "WeightSampleBatchOp":
        t = in_op.get_output_table()
        rng = np.random.RandomState(self.get_seed())
        w = np.asarray(t.col(self.get_weight_col()), np.float64)
        n = t.num_rows
        m = int(round(self.get_ratio() * n))
        # Efraimidis-Spirakis keys: u^(1/w) — top-m keeps weighted sample
        keys = rng.rand(n) ** (1.0 / np.maximum(w, 1e-300))
        idx = np.argsort(-keys)[:m]
        self._output = t.take_rows(np.sort(idx))
        return self


class SplitBatchOp(BatchOperator, HasSeed):
    """Random split; remainder on side output 0 (reference SplitBatchOp)."""
    FRACTION = ParamInfo("fraction", float, optional=False,
                         validator=RangeValidator(0.0, 1.0))

    def link_from(self, in_op: BatchOperator) -> "SplitBatchOp":
        t = in_op.get_output_table()
        rng = np.random.RandomState(self.get_seed())
        n = t.num_rows
        m = int(round(self.get_fraction() * n))
        perm = rng.permutation(n)
        self._output = t.take_rows(np.sort(perm[:m]))
        self._side_outputs = [t.take_rows(np.sort(perm[m:]))]
        return self


class FirstNBatchOp(BatchOperator):
    SIZE = ParamInfo("size", int, optional=False)

    def link_from(self, in_op: BatchOperator) -> "FirstNBatchOp":
        self._output = in_op.get_output_table().first_n(self.get_size())
        return self


class AppendIdBatchOp(BatchOperator):
    """Append a LONG id column (reference AppendIdBatchOp)."""
    ID_COL = ParamInfo("id_col", str, default="append_id")

    def link_from(self, in_op: BatchOperator) -> "AppendIdBatchOp":
        t = in_op.get_output_table()
        self._output = t.add_column(self.get_id_col(),
                                    np.arange(t.num_rows, dtype=np.int64),
                                    AlinkTypes.LONG)
        return self


class ShuffleBatchOp(BatchOperator, HasSeed):
    def link_from(self, in_op: BatchOperator) -> "ShuffleBatchOp":
        t = in_op.get_output_table()
        rng = np.random.RandomState(self.get_seed())
        self._output = t.take_rows(rng.permutation(t.num_rows))
        return self


class NumericalTypeCastBatchOp(BatchOperator, HasSelectedCols):
    """Cast numeric columns (reference NumericalTypeCastBatchOp)."""
    TARGET_TYPE = ParamInfo("target_type", str, default="DOUBLE")

    def link_from(self, in_op: BatchOperator) -> "NumericalTypeCastBatchOp":
        t = in_op.get_output_table()
        target = self.get_target_type().upper()
        dt = AlinkTypes.to_numpy_dtype(target)
        default = [n for n, tp in zip(t.schema.names, t.schema.types)
                   if AlinkTypes.is_numeric(tp)]
        for c in (self.get_selected_cols() or default):
            t = t.add_column(c, np.asarray(t.col(c), dtype=dt), target)
        self._output = t
        return self


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
