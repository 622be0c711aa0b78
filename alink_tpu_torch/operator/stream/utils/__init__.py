"""Generic stream-side mapper adapters.

Counterpart: ``alink_tpu/operator/stream/utils/__init__.py`` (the
re-design of the reference's stream/utils/: ModelMapStreamOp, the model
loaded once and applied per micro-batch with the batched mapper, and
the stateless MapStreamOp family). The model arrives from a batch
operator: a batch table handle crosses directly, where the reference
uses its DirectReader side channel. Ported: ``MapperStreamOp`` (alias
``MapStreamOp``) and ``ModelMapStreamOp``.
``ModelMapStreamOp`` runs the host mapper unless
``ALINK_TPU_SERVE_COMPILED`` is on (default off): then every
micro-batch goes through a ``CompiledPredictor`` — the serving tier's
bucketed kernels, on ``device`` (the card unless the caller asks for
the CPU) — and a batch whose geometry the kernel's encode refuses
(``GeometryRefused``) falls back to the host mapper for that batch,
recorded through ``record_serve_fallback``. Every other error of the
compiled route (a wrapper's refusal, a kernel that fails to launch)
propagates. ``PrintStreamOp`` and the UDF / UDTF /
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
                 params: Optional[Params] = None, mapper_cls=None,
                 device=None, **kwargs):
        super().__init__(params, **kwargs)
        if mapper_cls is not None:
            self.MAPPER_CLS = mapper_cls
        self._model_op = model_op
        self._mapper: Optional[ModelMapper] = None
        self._predictor = None
        # where the compiled route scores (resolved when it is on)
        self.device = device

    def _open(self, in_schema):
        model_table = self._model_op.get_output_table()
        self._mapper = self.MAPPER_CLS(model_table.schema, in_schema, self.params)
        self._mapper.load_model(model_table)
        self._open_predictor()
        return self._mapper.get_output_schema()

    def _open_predictor(self) -> None:
        """``ALINK_TPU_SERVE_COMPILED`` on: serve the micro-batches
        through a ``CompiledPredictor`` (None, recorded, for a mapper
        without a serving kernel); off: the host mapper."""
        self._predictor = None
        from ....serving.predictor import (CompiledPredictor,
                                           serve_compiled_enabled)
        if serve_compiled_enabled():
            self._predictor = CompiledPredictor.for_mapper(
                self._mapper, name=type(self).__name__, device=self.device)

    def _transform(self, mt: MTable):
        if self._predictor is not None:
            from ....serving.predictor import (GeometryRefused,
                                               record_serve_fallback)
            try:
                return self._predictor.predict_table(mt)
            except GeometryRefused as e:
                # the encode refusing the request geometry (e.g. more
                # features than the model) must not kill the stream —
                # THIS batch falls back to the host mapper, recorded
                # (alink_serve_fallback_total per batch + one
                # RuntimeWarning per mapper); the predictor stays
                record_serve_fallback(type(self._mapper).__name__,
                                      "geometry-refused", str(e))
        return self._mapper.map_table(mt)

    def link_from(self, *inputs) -> "ModelMapStreamOp":
        if len(inputs) == 2 and isinstance(inputs[0], BatchOperator):
            self._model_op = inputs[0]
            inputs = inputs[1:]
        return super().link_from(*inputs)


# reference stream/utils/MapStreamOp applies a Mapper per record — that is
# exactly MapperStreamOp's contract
MapStreamOp = MapperStreamOp
