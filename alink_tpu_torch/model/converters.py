"""Model <-> table converters.

PyTorch port: a copy of ``alink_tpu/model/converters.py``
(numpy only; the port keeps its own copy so that it never imports the
JAX package).

Re-design of the reference model persistence layer (common/model/:
SimpleModelDataConverter, RichModelDataConverter, LabeledModelDataConverter,
ModelConverterUtils). Models are tables of rows so they flow through the
same operator/IO fabric as data; converters define the row schema.

Format (mirrors SimpleModelDataConverter): rows of
  (model_id LONG, model_info STRING [, label_value <labelType>])
row 0 carries the meta Params JSON; subsequent rows carry data payload
strings; label values (when present) ride a dedicated typed column.
"""

from __future__ import annotations

import json
from typing import Any, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..common.mtable import MTable
from ..common.params import Params
from ..common.types import AlinkTypes, TableSchema


class ModelDataConverter:
    """save(model_data) -> MTable and load(MTable) -> model_data."""

    def save_model(self, model_data) -> MTable:  # pragma: no cover - interface
        raise NotImplementedError

    def load_model(self, table: MTable):  # pragma: no cover - interface
        raise NotImplementedError


class SimpleModelDataConverter(ModelDataConverter):
    """Meta params + list of data strings (reference SimpleModelDataConverter)."""

    SCHEMA = TableSchema(["model_id", "model_info"], [AlinkTypes.LONG, AlinkTypes.STRING])

    def serialize_model(self, model_data) -> Tuple[Params, List[str]]:
        raise NotImplementedError

    def deserialize_model(self, meta: Params, data: List[str]):
        raise NotImplementedError

    def save_model(self, model_data) -> MTable:
        meta, data = self.serialize_model(model_data)
        rows = [(0, meta.to_json())] + [(i + 1, s) for i, s in enumerate(data)]
        return MTable(rows, self.SCHEMA)

    def load_model(self, table: MTable):
        ids = np.asarray(table.col("model_id"), dtype=np.int64)
        infos = table.col("model_info")
        order = np.argsort(ids, kind="stable")
        meta = Params.from_json(str(infos[order[0]]))
        data = [str(infos[i]) for i in order[1:]]
        return self.deserialize_model(meta, data)


class LabeledModelDataConverter(ModelDataConverter):
    """Adds a typed label_value column (reference LabeledModelDataConverter)."""

    def __init__(self, label_type: str = AlinkTypes.STRING):
        self.label_type = label_type

    @property
    def schema(self) -> TableSchema:
        return TableSchema(["model_id", "model_info", "label_value"],
                           [AlinkTypes.LONG, AlinkTypes.STRING, self.label_type])

    def serialize_model(self, model_data) -> Tuple[Params, List[str], List[Any]]:
        raise NotImplementedError

    def deserialize_model(self, meta: Params, data: List[str], labels: List[Any]):
        raise NotImplementedError

    def save_model(self, model_data) -> MTable:
        meta, data, labels = self.serialize_model(model_data)
        rows = [(0, meta.to_json(), None)]
        rows += [(i + 1, s, None) for i, s in enumerate(data)]
        rows += [(len(rows) + i, None, l) for i, l in enumerate(labels)]
        return MTable(rows, self.schema)

    def load_model(self, table: MTable):
        ids = np.asarray(table.col("model_id"), dtype=np.int64)
        infos, labels_col = table.col("model_info"), table.col("label_value")
        order = np.argsort(ids, kind="stable")
        meta, data, labels = None, [], []
        for i in order:
            if labels_col[i] is not None and not _is_nan(labels_col[i]):
                labels.append(labels_col[i])
            elif infos[i] is not None and meta is None:
                meta = Params.from_json(str(infos[i]))
            elif infos[i] is not None:
                data.append(str(infos[i]))
        return self.deserialize_model(meta or Params(), data, labels)


def _is_nan(v) -> bool:
    return isinstance(v, float) and np.isnan(v)


def encode_array(arr: np.ndarray) -> str:
    """Compact json payload for numeric arrays in model_info rows."""
    a = np.asarray(arr)
    return json.dumps({"shape": list(a.shape), "data": a.reshape(-1).tolist()})


def decode_array(s: str, dtype=np.float64) -> np.ndarray:
    o = json.loads(s)
    return np.asarray(o["data"], dtype=dtype).reshape(o["shape"])
