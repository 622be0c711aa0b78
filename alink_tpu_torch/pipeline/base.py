"""Pipeline API: Estimator, Transformer, Model, Pipeline.

Counterpart: ``alink_tpu/pipeline/base.py`` (the re-design of the
reference's pipeline/: Pipeline.java:113 ``fit``, Trainer.java:45-104
trainer -> model creation, PipelineModel.java:128-149
transform / save / load, LocalPredictor.java, MapModel.java:38-60).
Ported: ``PipelineStage``, ``Transformer``, ``Estimator``, ``Model``,
``MapModel``, ``Trainer``, ``Pipeline``, ``PipelineModel`` (with
``transform_stream`` and its ``save`` / ``load`` of the
``"alink_tpu.pipeline.v1"`` JSON, class names the port's own),
``LocalPredictor`` and the chain predictors.

The port's difference: a stage takes ``device=`` (not a param, not
saved; ``clone()`` keeps it), a ``Trainer`` also ``dtype=``.
``Trainer.fit`` hands them to a train op that takes them (the linear, tree and KMeans train ops), so such an
estimator runs on ``cuda`` unless the caller asks for the CPU, and
raises without CUDA, and to the fitted model (a KMeans model assigns
there; a ``MapModel`` hands its device to a mapper that takes one, a
batch-op transformer to an op that takes one, DCT's). A ``Pipeline``'s
``device`` is the device of every estimator and batch-op transformer
that was given none. ``Trainer.enable_lazy_print_train_info`` /
``enable_lazy_print_model_info`` register the train op's lazy hooks in
``fit`` (``operator/base.py``), which ``execute()`` fires once.
"""

from __future__ import annotations

import functools
import importlib
import inspect
import json
import os
from typing import List, Optional, Tuple, Type

from ..common.mtable import MTable
from ..common.params import Params, WithParams
from ..mapper.base import ModelMapper
from ..operator.base import BatchOperator, TableSourceBatchOp

FORMAT = "alink_tpu.pipeline.v1"
PACKAGE = "alink_tpu_torch"


def caller_module(depth: int = 2) -> str:
    """__name__ of the module ``depth`` frames up.

    Class factories (_trainer/_wrap) mint classes on behalf of their caller;
    the minted class's ``__module__`` must name the caller's module or
    repr/pickle/docs attribution points at the factory instead.
    """
    import sys
    return sys._getframe(depth).f_globals.get("__name__", __name__)


class PipelineStage(WithParams):
    def __init__(self, params: Optional[Params] = None, device=None,
                 **kwargs):
        super().__init__(params, **kwargs)
        self.device = device

    def clone(self):
        return type(self)(self.params.clone(), device=self.device)


class Transformer(PipelineStage):
    def transform(self, in_op) -> BatchOperator:
        raise NotImplementedError


class Estimator(PipelineStage):
    def fit(self, in_op) -> "Model":
        raise NotImplementedError


class Model(Transformer):
    """A transformer backed by a model table."""

    def __init__(self, params: Optional[Params] = None, **kwargs):
        super().__init__(params, **kwargs)
        self.model_data: Optional[MTable] = None

    def set_model_data(self, table_or_op) -> "Model":
        self.model_data = (table_or_op.get_output_table()
                           if isinstance(table_or_op, BatchOperator) else table_or_op)
        return self

    def get_model_data(self) -> MTable:
        if self.model_data is None:
            raise RuntimeError(f"{type(self).__name__} has no model data")
        return self.model_data


class MapModel(Model):
    """Model applied through a ModelMapper (reference pipeline/MapModel.java)."""

    MAPPER_CLS: Optional[Type[ModelMapper]] = None

    def _mapper(self):
        """The mapper class, on this model's device where its mapper
        computes on one."""
        if "device" in inspect.signature(self.MAPPER_CLS.__init__).parameters:
            return functools.partial(self.MAPPER_CLS, device=self.device)
        return self.MAPPER_CLS

    def transform(self, in_op) -> BatchOperator:
        in_op = _as_op(in_op)
        from ..operator.batch.utils.model_map import ModelMapBatchOp
        op = ModelMapBatchOp(self.params.clone(), mapper_cls=self._mapper())
        return op.link_from(TableSourceBatchOp(self.get_model_data()), in_op)

    def get_local_predictor(self) -> "LocalPredictor":
        return LocalPredictor(self._mapper(), self.get_model_data(), self.params)


class Trainer(Estimator):
    """Estimator whose fit() runs a train batch op and wraps the model
    (reference pipeline/Trainer.java:45-48,89-104 ``createModel``).

    ``dtype=`` (a torch float dtype; not a param, not saved, ``clone()``
    keeps it) is handed to a train op that takes one; ``None`` leaves
    the op's own default (float32 for the linear family). It is the
    port's counterpart of the JAX package's x64 switch."""

    TRAIN_OP_CLS: Optional[Type[BatchOperator]] = None
    MODEL_CLS: Optional[Type[Model]] = None

    def __init__(self, params: Optional[Params] = None, device=None,
                 dtype=None, **kwargs):
        super().__init__(params, device=device, **kwargs)
        self.dtype = dtype

    def clone(self):
        out = super().clone()
        out.dtype = self.dtype
        return out

    def train_op(self, params: Params) -> BatchOperator:
        """An unlinked train op of ``params`` on this stage's device and
        dtype (where the op takes them)."""
        takes = inspect.signature(self.TRAIN_OP_CLS.__init__).parameters
        kw = {"device": self.device} if "device" in takes else {}
        if self.dtype is not None and "dtype" in takes:
            kw["dtype"] = self.dtype
        return self.TRAIN_OP_CLS(params, **kw)

    def fit(self, in_op) -> Model:
        in_op = _as_op(in_op)
        train_op = self.train_op(self.params.clone())
        train_op.link_from(in_op)
        self._last_train_op = train_op
        m = self.params._m
        if "__lazy_train_info" in m:
            if train_op.get_side_output_count() > 0:
                train_op.lazy_print_train_info(m["__lazy_train_info"])
            else:
                print(f"[alink_tpu_torch] {type(train_op).__name__} emits no "
                      "train info; lazy_print_train_info skipped")
        if "__lazy_model_info" in m:
            train_op.lazy_print_model_info(m["__lazy_model_info"])
        model = self.MODEL_CLS(self.params.clone(), device=self.device)
        model.set_model_data(train_op.get_output_table())
        return model

    # train-info hooks (reference WithTrainInfo.enableLazyPrintTrainInfo /
    # WithModelInfoBatchOp.enableLazyPrintModelInfo, fired from Trainer.fit,
    # pipeline/Trainer.java:50-66)
    def enable_lazy_print_train_info(self, title=None) -> "Trainer":
        # stored in params so the enablement survives PipelineStage.clone()
        # (meta-estimators like OneVsRest clone their sub-stages)
        self.params._m["__lazy_train_info"] = title
        return self

    def enable_lazy_print_model_info(self, title=None) -> "Trainer":
        self.params._m["__lazy_model_info"] = title
        return self

    def get_train_info(self) -> MTable:
        if not getattr(self, "_last_train_op", None):
            raise RuntimeError("fit() first")
        return self._last_train_op.get_side_output(0).get_output_table()


class Pipeline(Estimator):
    """Ordered stages; fit() trains estimators and chains transforms
    (reference pipeline/Pipeline.java:113)."""

    def __init__(self, *stages: PipelineStage, params: Optional[Params] = None,
                 device=None):
        super().__init__(params, device=device)
        self.stages: List[PipelineStage] = list(stages)

    def add(self, stage: PipelineStage) -> "Pipeline":
        self.stages.append(stage)
        return self

    def size(self) -> int:
        return len(self.stages)

    def get(self, i: int) -> PipelineStage:
        return self.stages[i]

    def _placed(self, stage: PipelineStage) -> PipelineStage:
        """The stage on this pipeline's device where it has none of its
        own (a clone; the caller's stage is left as it was)."""
        if self.device is None or stage.device is not None:
            return stage
        placed = stage.clone()
        placed.device = self.device
        return placed

    def fit(self, in_op) -> "PipelineModel":
        in_op = _as_op(in_op)
        fitted: List[Transformer] = []
        cur = in_op
        for stage in self.stages:
            if isinstance(stage, Estimator):
                model = self._placed(stage).fit(cur)
                fitted.append(model)
                cur = model.transform(cur)
            elif isinstance(stage, Transformer):
                if getattr(stage, "OP_CLS", None) is not None:
                    stage = self._placed(stage)    # a batch-op transformer
                fitted.append(stage)
                cur = stage.transform(cur)
            else:
                raise TypeError(f"stage {stage!r} is neither Estimator nor Transformer")
        return PipelineModel(*fitted)

    def fit_and_transform(self, in_op) -> Tuple["PipelineModel", BatchOperator]:
        model = self.fit(in_op)
        return model, model.transform(in_op)


class PipelineModel(Model):
    """Chain of fitted transformers (reference pipeline/PipelineModel.java)."""

    def __init__(self, *transformers: Transformer, params: Optional[Params] = None):
        super().__init__(params)
        self.transformers: List[Transformer] = list(transformers)

    def transform(self, in_op) -> BatchOperator:
        from ..operator.base import StreamOperator
        if isinstance(in_op, StreamOperator):
            return self.transform_stream(in_op)
        cur = _as_op(in_op)
        for t in self.transformers:
            cur = t.transform(cur)
        return cur

    def transform_stream(self, in_op):
        """Apply the fitted chain to a stream (reference
        PipelineModel.transform(StreamOperator), pipeline/PipelineModel.java):
        MapModels become ModelMapStreamOps; stateless batch-op transformers
        run per micro-batch."""
        from ..operator.stream.core import BatchApplyStreamOp
        from ..operator.stream.utils import ModelMapStreamOp
        cur = in_op
        for t in self.transformers:
            if isinstance(t, PipelineModel):
                cur = t.transform_stream(cur)
            elif isinstance(t, MapModel):
                op = ModelMapStreamOp(
                    TableSourceBatchOp(t.get_model_data()),
                    params=t.params.clone(), mapper_cls=t.MAPPER_CLS)
                cur = op.link_from(cur)
            elif getattr(t, "OP_CLS", None) is not None:
                cur = BatchApplyStreamOp(params=t.params.clone(),
                                         batch_cls=t.OP_CLS,
                                         device=t.device).link_from(cur)
            else:
                raise TypeError(f"{type(t).__name__} has no stream transform")
        return cur

    # -- persistence (reference ModelExporterUtils.java:40-120) -----------
    def save(self, path: str):
        stages = []
        for t in self.transformers:
            entry = {
                "className": f"{type(t).__module__}.{type(t).__qualname__}",
                "params": t.params.to_json(),
            }
            if isinstance(t, Model) and t.model_data is not None:
                entry["modelData"] = t.get_model_data().to_json_rows()
            stages.append(entry)
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            json.dump({"format": FORMAT, "stages": stages}, f)

    @staticmethod
    def load(path: str) -> "PipelineModel":
        """A pipeline the port saved. A class outside ``alink_tpu_torch``
        (a file the JAX package saved) raises: load that one through
        ``model/interop.py::pipeline_model_from_reference``."""
        with open(path, "r", encoding="utf-8") as f:
            obj = json.load(f)
        return stages_from_json(obj, lambda name: name)

    def get_local_predictor(self) -> "_ChainPredictor":
        preds = []
        for t in self.transformers:
            if hasattr(t, "get_local_predictor"):
                preds.append(t.get_local_predictor())
            else:
                preds.append(_TransformerPredictor(t))
        return _ChainPredictor(preds)


def stages_from_json(obj: dict, rename) -> PipelineModel:
    """The ``PipelineModel`` of a parsed pipeline file; ``rename`` maps
    each stage's class name to the port's. A name outside the port, or
    one the port lacks, raises."""
    if obj.get("format") != FORMAT:
        raise ValueError(f"not a {FORMAT} pipeline: {obj.get('format')!r}")
    transformers = []
    for entry in obj["stages"]:
        name = rename(entry["className"])
        mod_name, _, cls_name = name.rpartition(".")
        if mod_name.split(".")[0] != PACKAGE:
            raise ValueError(
                f"stage class {entry['className']!r} is not a class of "
                f"{PACKAGE}; load a file the JAX package saved with "
                f"model.interop.pipeline_model_from_reference")
        try:
            cls = getattr(importlib.import_module(mod_name), cls_name)
        except (ImportError, AttributeError):
            raise ValueError(
                f"stage class {entry['className']!r}: {name} is not "
                f"ported") from None
        t = cls(Params.from_json(entry["params"]))
        if "modelData" in entry:
            t.set_model_data(MTable.from_json_rows(entry["modelData"]))
        transformers.append(t)
    return PipelineModel(*transformers)


class LocalPredictor:
    """Embedded single-row/small-batch serving (reference pipeline/LocalPredictor.java:18-49).

    No session/engine involvement — pure host mapper application.
    """

    def __init__(self, mapper_cls: Type[ModelMapper], model_data: MTable,
                 params: Params, data_schema=None):
        self.mapper_cls = mapper_cls
        self.model_data = model_data
        self.params = params
        self._mapper: Optional[ModelMapper] = None
        self._schema = data_schema

    def _ensure(self, schema):
        if self._mapper is None:
            self._mapper = self.mapper_cls(self.model_data.schema, schema, self.params)
            self._mapper.load_model(self.model_data)
        return self._mapper

    def map(self, row: Tuple, schema=None) -> Tuple:
        if schema is None and self._schema is None:
            raise ValueError("LocalPredictor.map needs a data schema on first use")
        schema = schema or self._schema
        self._schema = schema
        return self._ensure(schema).map_row(row)

    def predict(self, table: MTable) -> MTable:
        return self._ensure(table.schema).map_table(table)


class _TransformerPredictor:
    def __init__(self, transformer: Transformer):
        self.t = transformer

    def predict(self, table: MTable) -> MTable:
        return self.t.transform(TableSourceBatchOp(table)).get_output_table()


class _ChainPredictor:
    def __init__(self, predictors):
        self.predictors = predictors

    def predict(self, table: MTable) -> MTable:
        for p in self.predictors:
            table = p.predict(table)
        return table

    def map(self, row: Tuple, schema) -> Tuple:
        t = MTable([row], schema)
        return self.predict(t).row(0)


def _as_op(in_op) -> BatchOperator:
    if isinstance(in_op, BatchOperator):
        return in_op
    if isinstance(in_op, MTable):
        return TableSourceBatchOp(in_op)
    raise TypeError(f"expected BatchOperator or MTable, got {type(in_op)}")
