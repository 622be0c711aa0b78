"""String indexing operators.

Counterpart: ``alink_tpu/operator/batch/dataproc/indexers.py``, the
re-design of common/dataproc/ StringIndexerTrain/Predict,
MultiStringIndexer and IndexToString (ordered token -> LONG index
models). Host Python, as there; none takes a device. The token orders
are the JAX package's: ``random`` is the first-seen order, the
frequency orders break ties by the token (Python's stable ``sorted``).
The port's difference: the mappers declare their output schema, so
their stream twins open (the JAX package's do not).
"""


from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np

from ....common.mtable import MTable
from ....common.params import InValidator, ParamInfo, Params
from ....common.types import AlinkTypes, TableSchema
from ....mapper.base import ModelMapper, OutputColsHelper
from ....model.converters import SimpleModelDataConverter
from ....params.shared import (HasOutputCol, HasOutputCols, HasReservedCols,
                               HasSelectedCol, HasSelectedCols)
from ...base import BatchOperator
from ..utils.model_map import ModelMapBatchOp


def _order_tokens(values, order: str) -> List[str]:
    toks = [str(v) for v in values if v is not None]
    if order == "random":
        uniq = list(dict.fromkeys(toks))
        return uniq
    from collections import Counter
    cnt = Counter(toks)
    if order == "frequency_asc":
        return [t for t, _ in sorted(cnt.items(), key=lambda kv: (kv[1], kv[0]))]
    if order == "frequency_desc":
        return [t for t, _ in sorted(cnt.items(), key=lambda kv: (-kv[1], kv[0]))]
    if order == "alphabet_asc":
        return sorted(cnt)
    if order == "alphabet_desc":
        return sorted(cnt, reverse=True)
    raise ValueError(order)


class StringIndexerModelConverter(SimpleModelDataConverter):
    def serialize_model(self, model: Dict[str, List[str]]):
        return Params({"cols": list(model)}), [json.dumps(model)]

    def deserialize_model(self, meta, data):
        return json.loads(data[0])


class StringIndexerTrainBatchOp(BatchOperator, HasSelectedCol, HasSelectedCols):
    """reference: dataproc/StringIndexerTrainBatchOp (MultiStringIndexer when
    several columns are selected)."""
    STRING_ORDER_TYPE = ParamInfo(
        "string_order_type", str, default="random",
        validator=InValidator(["random", "frequency_asc", "frequency_desc",
                               "alphabet_asc", "alphabet_desc"]))

    def link_from(self, in_op: BatchOperator) -> "StringIndexerTrainBatchOp":
        t = in_op.get_output_table()
        cols = self.params._m.get("selected_cols") or [self.get_selected_col()]
        order = self.get_string_order_type()
        model = {c: _order_tokens(t.col(c), order) for c in cols}
        self._output = StringIndexerModelConverter().save_model(model)
        return self


class MultiStringIndexerTrainBatchOp(StringIndexerTrainBatchOp):
    pass


class StringIndexerModelMapper(ModelMapper):
    def __init__(self, model_schema, data_schema, params=None, **kwargs):
        super().__init__(model_schema, data_schema, params, **kwargs)
        self.model: Optional[Dict[str, List[str]]] = None

    def load_model(self, model_table: MTable):
        self.model = StringIndexerModelConverter().load_model(model_table)

    def _cols(self):
        """(selected columns, output columns)."""
        sel = self.params._m.get("selected_cols") or [self.params._m["selected_col"]]
        out_cols = (self.params._m.get("output_cols")
                    or ([self.params._m["output_col"]]
                        if self.params._m.get("output_col") else sel))
        return sel, out_cols

    def get_output_schema(self):
        _, out_cols = self._cols()
        return OutputColsHelper(self.data_schema, out_cols,
                                [AlinkTypes.LONG] * len(out_cols)
                                ).get_output_schema()

    def map_table(self, data: MTable) -> MTable:
        sel, out_cols = self._cols()
        handle = (self.params._m.get("handle_invalid") or "keep").lower()
        outs = []
        for c, _oc in zip(sel, out_cols):
            if c in self.model:
                vocab = self.model[c]
            elif len(self.model) == 1:
                # single-col model may be applied to a differently-named column
                vocab = next(iter(self.model.values()))
            else:
                raise KeyError(f"column {c!r} not in indexer model "
                               f"(trained on {sorted(self.model)})")
            lookup = {t: i for i, t in enumerate(vocab)}
            vals = []
            for v in data.col(c):
                key = None if v is None else str(v)
                if key in lookup:
                    vals.append(lookup[key])
                elif handle == "keep":
                    vals.append(len(lookup))
                elif handle == "skip":
                    vals.append(-1)
                else:
                    raise ValueError(f"unseen token {v!r} in column {c}")
            outs.append(np.asarray(vals, np.int64))
        helper = OutputColsHelper(data.schema, out_cols,
                                  [AlinkTypes.LONG] * len(out_cols))
        return helper.build_output(data, outs)


class StringIndexerPredictBatchOp(ModelMapBatchOp, HasSelectedCol, HasSelectedCols,
                                  HasOutputCol, HasOutputCols, HasReservedCols):
    MAPPER_CLS = StringIndexerModelMapper
    HANDLE_INVALID = ParamInfo("handle_invalid", str, default="keep",
                               validator=InValidator(["keep", "skip", "error"]))


class MultiStringIndexerPredictBatchOp(StringIndexerPredictBatchOp):
    pass


class IndexToStringModelMapper(ModelMapper):
    def __init__(self, model_schema, data_schema, params=None, **kwargs):
        super().__init__(model_schema, data_schema, params, **kwargs)
        self.model = None

    def load_model(self, model_table: MTable):
        self.model = StringIndexerModelConverter().load_model(model_table)

    def get_output_schema(self):
        sel = self.params._m["selected_col"]
        out_col = self.params._m.get("output_col") or sel
        return OutputColsHelper(self.data_schema, [out_col],
                                [AlinkTypes.STRING]).get_output_schema()

    def map_table(self, data: MTable) -> MTable:
        sel = self.params._m["selected_col"]
        out_col = self.params._m.get("output_col") or sel
        model_col = self.params._m.get("model_name_col")
        vocab = (self.model.get(model_col) if model_col
                 else next(iter(self.model.values())))
        vals = np.empty(data.num_rows, object)
        col = data.col(sel)
        for i, v in enumerate(col):
            iv = int(v)
            vals[i] = vocab[iv] if 0 <= iv < len(vocab) else None
        helper = OutputColsHelper(data.schema, [out_col], [AlinkTypes.STRING])
        return helper.build_output(data, [vals])


class IndexToStringPredictBatchOp(ModelMapBatchOp, HasSelectedCol, HasOutputCol):
    """reference: dataproc/IndexToStringPredictBatchOp."""
    MAPPER_CLS = IndexToStringModelMapper
    MODEL_NAME_COL = ParamInfo("model_name_col", str, "which indexed column's vocab")
