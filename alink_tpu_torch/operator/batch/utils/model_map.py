"""Generic model-apply operators.

Counterpart: ``alink_tpu/operator/batch/utils/model_map.py`` (the
re-design of batch/utils/ModelMapBatchOp.java:33-55): the mapper is
loaded once and applied to the whole table on the host.
``DeviceModelMapBatchOp`` and ``DeviceTrainBatchOp`` are the port's own:
the op for a mapper that computes on a device, and the base of a train op
that runs on a device in a float dtype.
"""

from __future__ import annotations

from typing import Optional, Type

import numpy as np
import torch

from ....common.device import resolve_device
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


class DeviceModelMapBatchOp(ModelMapBatchOp):
    """A ``ModelMapBatchOp`` whose mapper computes on ``device``
    (``cuda`` unless the caller asks for the CPU; raises without it)."""

    def __init__(self, params: Optional[Params] = None, device=None,
                 **kwargs):
        super().__init__(params, **kwargs)
        self.device = resolve_device(device)

    def link_from(self, model_op: BatchOperator,
                  data_op: BatchOperator) -> "DeviceModelMapBatchOp":
        mapper = self.MAPPER_CLS(model_op.get_schema(), data_op.get_schema(),
                                 self.params, device=self.device)
        mapper.load_model(model_op.get_output_table())
        self._output = mapper.map_table(data_op.get_output_table())
        return self


class DeviceTrainBatchOp(BatchOperator):
    """A train op on ``device`` (``cuda`` unless the caller asks for the
    CPU; raises without it) in ``dtype`` (``torch.float32`` by default;
    ``torch.float64`` for parity with the JAX package under x64, where
    it reads ``jax_enable_x64``). ``np_dtype`` is the numpy twin."""

    NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}

    def __init__(self, params: Optional[Params] = None, device=None,
                 dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(params, **kwargs)
        if dtype not in self.NP_DTYPES:
            raise ValueError(f"dtype {dtype}: want torch.float32 or "
                             f"torch.float64")
        self.device = resolve_device(device)
        self.dtype = dtype

    @property
    def np_dtype(self):
        return self.NP_DTYPES[self.dtype]
