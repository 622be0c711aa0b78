"""Generic stream-side mapper adapters.

Counterpart: ``alink_tpu/operator/stream/utils/__init__.py`` (the
re-design of the reference's stream/utils/: ModelMapStreamOp, the model
loaded once and applied per micro-batch with the batched mapper, and
the stateless MapStreamOp family). The model arrives from a batch
operator: a batch table handle crosses directly, where the reference
uses its DirectReader side channel. Ported: ``MapperStreamOp`` (alias
``MapStreamOp``) and ``ModelMapStreamOp``.
``ModelMapStreamOp`` runs the host mapper: the JAX package's opt-in
route through its compiled serving programs (``ALINK_TPU_SERVE_
COMPILED``) is not ported. ``PrintStreamOp`` and the UDF / UDTF /
FlatMap twins wait for later slices (the twins for their batch ops,
``operator/batch/utils/fn_ops.py``).
"""

from __future__ import annotations

from typing import Optional, Type

from ....common.mtable import MTable
from ....common.params import Params
from ....mapper.base import Mapper, ModelMapper
from ...base import BatchOperator
from ..core import BaseStreamTransformOp


class MapperStreamOp(BaseStreamTransformOp):
    """Stateless mapper applied to each micro-batch."""

    MAPPER_CLS: Optional[Type[Mapper]] = None

    def __init__(self, params: Optional[Params] = None, mapper_cls=None, **kwargs):
        super().__init__(params, **kwargs)
        if mapper_cls is not None:
            self.MAPPER_CLS = mapper_cls
        self._mapper: Optional[Mapper] = None

    def _open(self, in_schema):
        self._mapper = self.MAPPER_CLS(in_schema, self.params)
        return self._mapper.get_output_schema()

    def _transform(self, mt: MTable):
        return self._mapper.map_table(mt)


class ModelMapStreamOp(BaseStreamTransformOp):
    """Apply a trained (batch) model to a stream (reference
    stream/utils/ModelMapStreamOp; model via DataBridge broadcast)."""

    MAPPER_CLS: Optional[Type[ModelMapper]] = None

    def __init__(self, model_op: Optional[BatchOperator] = None,
                 params: Optional[Params] = None, mapper_cls=None, **kwargs):
        super().__init__(params, **kwargs)
        if mapper_cls is not None:
            self.MAPPER_CLS = mapper_cls
        self._model_op = model_op
        self._mapper: Optional[ModelMapper] = None

    def _open(self, in_schema):
        model_table = self._model_op.get_output_table()
        self._mapper = self.MAPPER_CLS(model_table.schema, in_schema, self.params)
        self._mapper.load_model(model_table)
        return self._mapper.get_output_schema()

    def _transform(self, mt: MTable):
        return self._mapper.map_table(mt)

    def link_from(self, *inputs) -> "ModelMapStreamOp":
        if len(inputs) == 2 and isinstance(inputs[0], BatchOperator):
            self._model_op = inputs[0]
            inputs = inputs[1:]
        return super().link_from(*inputs)


# reference stream/utils/MapStreamOp applies a Mapper per record — that is
# exactly MapperStreamOp's contract
MapStreamOp = MapperStreamOp
