"""Linear-model training core, the model value object and its converter.

Counterpart: ``alink_tpu/operator/common/linear/base.py`` (the
reference's BaseLinearModelTrainBatchOp.java flow: label encode ->
design -> standardization -> ``optimize()`` -> model rows through
LinearModelDataConverter). The table format is the JAX package's, so a
model table saved by either package loads in the other
(``model/interop.py``).

The JAX package picks its dtype from ``jax_enable_x64``; the port takes
it from the train op (``dtype=``: ``torch.float32`` by default, as
FTRL's ``ship_dtype``; ``torch.float64`` for parity with the JAX package
under x64), and its device from the op (``device=``: ``cuda`` unless the
caller asks for the CPU). Field-aware-hashed input is detected and
trains field-blocked, with the intercept as a prepended constant field,
as in the JAX package.

Every model type of ``LinearModelType`` but AFT trains: the binary and
regression types through ``UnaryLossObjFunc`` with their losses
(``LinearModelType.LOSSES``), Softmax through ``SoftmaxObjFunc`` on
integer class ids, with no field-blocked layout.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ....common.mlenv import MLEnvironment
from ....common.mtable import MTable
from ....common.params import Params
from ....common.types import AlinkTypes
from ....model.converters import (LabeledModelDataConverter, decode_array,
                                  encode_array)
from ..dataproc.feature_extract import (add_intercept, extract_design,
                                        resolve_feature_cols)
from ..optim.objfunc import (HingeLossFunc, LogLossFunc, PerceptronLossFunc,
                             SoftmaxObjFunc, SquareLossFunc, SvrLossFunc,
                             UnaryLossObjFunc)
from ..optim.optimizers import OptimParams, optimize


class LinearModelType:
    LR = "LR"
    SVM = "SVM"
    LinearReg = "LinearReg"
    SVR = "SVR"
    Perceptron = "Perceptron"
    Softmax = "Softmax"
    AFT = "AFT"

    LOSSES = {
        "LR": LogLossFunc, "SVM": HingeLossFunc, "LinearReg": SquareLossFunc,
        "SVR": SvrLossFunc, "Perceptron": PerceptronLossFunc,
    }
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


def encode_labels(raw_labels: np.ndarray, positive_value=None) -> Tuple[List[Any], np.ndarray]:
    """Distinct labels + per-row {-1,+1} targets (binary).

    reference: getLabelInfo/getLabelValues (BaseLinearModelTrainBatchOp.java).
    Ordering: positive label first; default positive = largest distinct
    (so numeric {0,1} gets positive=1).
    """
    distinct = sorted(set(_canon(v) for v in raw_labels), key=_sort_key, reverse=True)
    if len(distinct) != 2:
        raise ValueError(f"binary trainer needs exactly 2 label values, got {distinct}")
    if positive_value is not None:
        pv = _canon(positive_value)
        match = [l for l in distinct if str(l) == str(pv)]
        if not match:
            raise ValueError(f"positive label {positive_value!r} not in {distinct}")
        distinct = [match[0]] + [l for l in distinct if l is not match[0]]
    y = np.where([_canon(v) == distinct[0] for v in raw_labels], 1.0, -1.0)
    return distinct, y


def index_labels(raw_labels: np.ndarray) -> Tuple[List[Any], np.ndarray]:
    """Distinct labels + integer class ids (multiclass, reference Softmax)."""
    distinct = sorted(set(_canon(v) for v in raw_labels), key=_sort_key)
    lookup = {l: i for i, l in enumerate(distinct)}
    y = np.asarray([lookup[_canon(v)] for v in raw_labels], np.float64)
    return distinct, y


def _canon(v):
    if isinstance(v, (np.generic,)):
        return v.item()
    return v


def _sort_key(v):
    return (0, float(v)) if isinstance(v, (int, float, bool)) else (1, str(v))


@dataclass
class LinearTrainPrep:
    """The hyperparameter-independent half of the linear train flow:
    design extraction, label encoding, standardization moments and
    field-block detection, everything up to ``optimize()``."""
    env: Any
    dtype: Any
    model_type: str
    softmax: bool
    regression: bool
    labels: List[Any]
    label_type: str
    train: Dict[str, np.ndarray]
    dim: int
    feat_dim: int
    mean: np.ndarray
    std: np.ndarray
    standardize: bool
    with_intercept: bool
    fb_meta: Any                    # augmented FieldBlockMeta, or None
    reg_free: int
    vector_col: Optional[str]
    feature_cols: Optional[List[str]]
    loss_kwargs: Dict[str, Any]

    def objective(self, l1: float, l2: float):
        """The training objective at (l1, l2)."""
        if self.softmax:
            return SoftmaxObjFunc(len(self.labels), self.dim, l1=l1, l2=l2,
                                  reg_free_cols=self.reg_free)
        loss_cls = LinearModelType.LOSSES[self.model_type]
        return UnaryLossObjFunc(loss_cls(**self.loss_kwargs), self.dim,
                                l1=l1, l2=l2, reg_free_head=self.reg_free,
                                fb_meta=self.fb_meta)

    def finish(self, coef, loss_curve) -> Tuple[MTable, MTable]:
        """Fitted coefficients -> (model_table, train_info): fb
        intercept de-augmentation, de-standardization, model rows."""
        coef = np.asarray(coef)
        if self.fb_meta is not None and self.with_intercept:
            # de-augment: [intercept slot, dead slots..., features]
            coef = np.concatenate([coef[:1],
                                   coef[self.fb_meta.field_size:]])
        if self.standardize:
            coef = _destandardize_coef(coef, self.mean, self.std,
                                       self.with_intercept, self.softmax,
                                       len(self.labels))
        model = LinearModelData(
            model_name=f"{self.model_type} model",
            linear_model_type=self.model_type,
            has_intercept=bool(self.with_intercept),
            vector_col=self.vector_col,
            feature_names=self.feature_cols if not self.vector_col else None,
            vector_size=int(self.feat_dim),
            coef=np.asarray(coef, np.float64), label_values=self.labels,
            label_type=self.label_type, loss_curve=loss_curve)
        model_table = LinearModelDataConverter(
            self.label_type).save_model(model)
        info = MTable({"iter": np.arange(1, len(loss_curve) + 1),
                       "loss": np.asarray(loss_curve, np.float64)})
        return model_table, info


def prepare_linear_train(data: MTable, op, model_type: str
                         ) -> LinearTrainPrep:
    """The front half of :func:`train_linear_model`. ``op`` supplies the
    params and its ``device`` and ``dtype`` (a torch float dtype)."""
    env = MLEnvironment(device=op.device)
    feature_cols = op.params._m.get("feature_cols")
    vector_col = op.params._m.get("vector_col")
    label_col = op.params._m.get("label_col")
    weight_col = op.params._m.get("weight_col")
    with_intercept = op.params._m.get("with_intercept", True)
    standardize = op.params._m.get("standardization", True)
    dtype = np.float64 if op.dtype == torch.float64 else np.float32

    if not vector_col:
        feature_cols = resolve_feature_cols(data, feature_cols, label_col,
                                            exclude=[weight_col] if weight_col else [])
    design = extract_design(data, feature_cols, vector_col, dtype)
    n = data.num_rows
    w = (np.asarray(data.col(weight_col), dtype) if weight_col
         else np.ones(n, dtype))

    # -- label encoding --------------------------------------------------
    softmax = model_type == LinearModelType.Softmax
    regression = model_type in LinearModelType.IS_REGRESSION
    raw = data.col(label_col)
    label_type = data.schema.type_of(label_col)
    if regression:
        labels, y = [], np.asarray(raw, dtype)
    elif softmax:
        labels, y = index_labels(raw)
    else:
        labels, y = encode_labels(raw, op.params._m.get("positive_label_value_string"))

    # -- standardization (reference :111-180) ----------------------------
    mean, std = _weighted_moments(design, w)
    if design["kind"] == "sparse":
        mean = np.zeros_like(mean)  # sparse path scales only; no centering

    # field-blocked path (ops/fieldblock.py): field-aware-hashed input;
    # the intercept becomes a prepended constant field (local index 0) so
    # fields stay uniform; its unused slots get no gradient and stay 0.
    fb = None
    if design["kind"] == "sparse" and not softmax:
        from ....ops.fieldblock import detect_fieldblock
        fb = detect_fieldblock(design["idx"], design["val"], design["dim"])
    feat_dim = design["dim"]  # pre-intercept feature dim (model vector_size)
    if fb is not None:
        fb_idx, fb_val, meta = fb
        if standardize:
            from ....ops.fieldblock import fb_to_flat_indices
            scale = (1.0 / std).astype(dtype)
            flat = fb_to_flat_indices(fb_idx, meta)
            fb_val = (scale[flat] if fb_val is None else
                      fb_val.astype(dtype) * scale[flat])
        if with_intercept:
            from ....ops.fieldblock import FieldBlockMeta
            fb_idx = np.concatenate(
                [np.zeros((n, 1), fb_idx.dtype), fb_idx], axis=1)
            if fb_val is not None:
                fb_val = np.concatenate(
                    [np.ones((n, 1), fb_val.dtype), fb_val], axis=1)
            meta = FieldBlockMeta(meta.num_fields + 1, meta.field_size)
        dim = meta.dim
    else:
        if standardize:
            design = _apply_standardization(design, mean, std)
        if with_intercept:
            design = add_intercept(design, dtype)
        dim = design["dim"]

    # the fb intercept field owns the first field_size slots, all reg-free
    reg_free = 0 if not with_intercept else \
        (meta.field_size if fb is not None else 1)
    loss_kwargs: Dict[str, Any] = {}
    if model_type == LinearModelType.SVR:
        loss_kwargs["epsilon"] = float(op.params._m.get("tau", 0.1))

    if fb is not None:
        train = {"fb_idx": fb_idx}
        if fb_val is not None:
            train["fb_val"] = fb_val
    else:
        train = {k2: v for k2, v in design.items() if k2 in ("X", "idx", "val")}
    train["y"] = y.astype(dtype)
    train["w"] = w
    return LinearTrainPrep(
        env=env, dtype=dtype, model_type=model_type, softmax=softmax,
        regression=regression, labels=labels, label_type=label_type,
        train=train, dim=dim, feat_dim=int(feat_dim), mean=mean, std=std,
        standardize=bool(standardize), with_intercept=bool(with_intercept),
        fb_meta=meta if fb is not None else None, reg_free=reg_free,
        vector_col=vector_col, feature_cols=feature_cols,
        loss_kwargs=loss_kwargs)


def train_linear_model(data: MTable, op, model_type: str) -> Tuple[MTable, MTable]:
    """Full train flow; ``op`` supplies params, ``device`` and ``dtype``.
    Returns (model_table, train_info)."""
    prep = prepare_linear_train(data, op, model_type)
    l1 = float(op.params._m.get("l1", 0.0) or 0.0)
    l2 = float(op.params._m.get("l2", 0.0) or 0.0)
    method = _default_method(op, l1)
    lr = op.params._m.get("learning_rate")
    if lr is None:
        lr = default_learning_rate(method)
    optim = OptimParams(
        method=method,
        max_iter=int(op.params._m.get("max_iter", 100)),
        epsilon=float(op.params._m.get("epsilon", 1e-6)),
        learning_rate=float(lr),
        mini_batch_fraction=float(op.params._m.get("mini_batch_fraction", 0.1)),
        seed=int(op.params._m.get("seed", 0) or 0),
    )
    obj = prep.objective(l1, l2)
    coef, loss_curve, steps = optimize(obj, prep.train, optim, prep.env)
    return prep.finish(coef, loss_curve)


def _default_method(op, l1: float) -> str:
    """Explicit ``optim_method`` wins; otherwise OWLQN iff l1 > 0."""
    m = op.params._m.get("optim_method")
    if m:
        return str(m)
    return "OWLQN" if l1 > 0 else "LBFGS"


def default_learning_rate(method: str) -> float:
    """The default when no ``learning_rate`` param is set: line-search
    base for the (quasi-)Newton methods; step size for SGD."""
    return 0.1 if method.upper() == "SGD" else 1.0


def _weighted_moments(design: Dict, w: np.ndarray):
    W = max(float(w.sum()), 1e-12)
    if design["kind"] == "dense":
        X = design["X"]
        mean = (X * w[:, None]).sum(0) / W
        var = ((X - mean) ** 2 * w[:, None]).sum(0) / W
    else:
        dim = design["dim"]
        idx, val = design["idx"], design["val"]
        mean = np.zeros(dim, val.dtype)
        sq = np.zeros(dim, val.dtype)
        np.add.at(mean, idx.reshape(-1), (val * w[:, None]).reshape(-1))
        np.add.at(sq, idx.reshape(-1), (val ** 2 * w[:, None]).reshape(-1))
        mean /= W
        var = sq / W - mean ** 2  # zeros count toward the moments
    std = np.sqrt(np.maximum(var, 0.0))
    std = np.where(std < 1e-12, 1.0, std)
    return mean, std


def _apply_standardization(design: Dict, mean, std):
    if design["kind"] == "dense":
        # center + scale (reference standardizes dense input)
        return {"kind": "dense", "X": (design["X"] - mean) / std, "dim": design["dim"]}
    # sparse: scale only, centering would densify
    val = design["val"] / std[design["idx"]]
    return {"kind": "sparse", "idx": design["idx"], "val": val, "dim": design["dim"]}


def _destandardize_coef(coef, mean, std, with_intercept, softmax, k):
    if softmax:
        W = coef.reshape(k - 1, -1)
        if with_intercept:
            b, Wf = W[:, 0], W[:, 1:]
            Wo = Wf / std
            bo = b - (Wf * (mean / std)).sum(1)
            return np.concatenate([bo[:, None], Wo], 1).reshape(-1)
        return (W / std).reshape(-1)
    if with_intercept:
        b, wf = coef[0], coef[1:]
        wo = wf / std
        bo = b - float((wf * (mean / std)).sum())
        return np.concatenate([[bo], wo])
    return coef / std
