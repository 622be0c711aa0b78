"""Generic model-apply operators.

Counterpart: ``alink_tpu/operator/batch/utils/model_map.py`` (the
re-design of batch/utils/ModelMapBatchOp.java:33-55): the mapper is
loaded once and applied to the whole table on the host.
"""

from __future__ import annotations

from typing import Optional, Type

from ....common.params import Params
from ....mapper.base import ModelMapper
from ...base import BatchOperator


class MapBatchOp(BatchOperator):
    """Stateless mapper applied to the whole table (reference
    batch/utils/MapBatchOp.java)."""

    MAPPER_CLS = None

    def __init__(self, params: Optional[Params] = None, mapper_cls=None, **kwargs):
        super().__init__(params, **kwargs)
        if mapper_cls is not None:
            self.MAPPER_CLS = mapper_cls

    def link_from(self, in_op: BatchOperator) -> "MapBatchOp":
        mapper = self.MAPPER_CLS(in_op.get_schema(), self.params)
        self._output = mapper.map_table(in_op.get_output_table())
        return self


class ModelMapBatchOp(BatchOperator):
    MAPPER_CLS: Optional[Type[ModelMapper]] = None

    def __init__(self, params: Optional[Params] = None, mapper_cls=None, **kwargs):
        super().__init__(params, **kwargs)
        if mapper_cls is not None:
            self.MAPPER_CLS = mapper_cls

    def link_from(self, model_op: BatchOperator, data_op: BatchOperator) -> "ModelMapBatchOp":
        mapper = self.MAPPER_CLS(model_op.get_schema(), data_op.get_schema(),
                                 self.params)
        mapper.load_model(model_op.get_output_table())
        self._output = mapper.map_table(data_op.get_output_table())
        return self
