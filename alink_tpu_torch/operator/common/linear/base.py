"""The linear model value object and its model-table converter.

Counterpart: ``alink_tpu/operator/common/linear/base.py``. Only
``LinearModelType`` (without its ``LOSSES`` map), ``LinearModelData``
and ``LinearModelDataConverter`` are ported: training, which needs the
losses and the optimizers, comes with a later slice. The table format
is the JAX package's, so a model table saved by either package loads in
the other (``model/interop.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional

import numpy as np

from ....common.params import Params
from ....common.types import AlinkTypes
from ....model.converters import (LabeledModelDataConverter, decode_array,
                                  encode_array)


class LinearModelType:
    LR = "LR"
    SVM = "SVM"
    LinearReg = "LinearReg"
    SVR = "SVR"
    Perceptron = "Perceptron"
    Softmax = "Softmax"
    AFT = "AFT"

    IS_REGRESSION = {"LinearReg", "SVR"}


@dataclass
class LinearModelData:
    model_name: str
    linear_model_type: str
    has_intercept: bool
    vector_col: Optional[str]
    feature_names: Optional[List[str]]
    vector_size: int
    coef: np.ndarray                       # (dim,) or flattened (k-1, dim) for Softmax
    label_values: List[Any] = field(default_factory=list)
    label_type: str = AlinkTypes.STRING
    loss_curve: Optional[np.ndarray] = None


class LinearModelDataConverter(LabeledModelDataConverter):
    """Model rows (reference common/linear/LinearModelDataConverter.java)."""

    def __init__(self, label_type: str = AlinkTypes.STRING):
        super().__init__(label_type)

    @classmethod
    def load_table(cls, table) -> "LinearModelData":
        """Load a serialized linear model table, sniffing the label
        type from its third column (the labeled layout's label slot;
        STRING for the label-less two-column shape). The ONE
        label-type/positive-label convention every consumer of a
        linear model table must share — the FTRL warm start, the
        predict mapper, and the online DAG's eval leg all load
        through here (``label_values[0]`` is the positive label)."""
        label_type = table.schema.types[2] if len(table.schema) > 2 \
            else AlinkTypes.STRING
        return cls(label_type).load_model(table)

    def serialize_model(self, m: LinearModelData):
        meta = Params({
            "model_name": m.model_name, "linear_model_type": m.linear_model_type,
            "has_intercept": m.has_intercept, "vector_col": m.vector_col,
            "feature_names": m.feature_names, "vector_size": m.vector_size,
            "label_type": m.label_type,
        })
        return meta, [encode_array(m.coef)], list(m.label_values)

    def deserialize_model(self, meta: Params, data: List[str], labels: List[Any]):
        get = lambda k, d=None: meta._m.get(k, d)  # noqa: E731
        return LinearModelData(
            model_name=get("model_name", ""),
            linear_model_type=get("linear_model_type", "LR"),
            has_intercept=bool(get("has_intercept", True)),
            vector_col=get("vector_col"),
            feature_names=get("feature_names"),
            vector_size=int(get("vector_size", 0)),
            coef=decode_array(data[0]),
            label_values=labels,
            label_type=get("label_type", AlinkTypes.STRING),
        )
