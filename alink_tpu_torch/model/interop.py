"""Carry a linear model, or an FTRL state, across from the JAX package or
from numpy arrays.

No counterpart module in ``alink_tpu``: both packages store a linear
model as the same table of ``(model_id, model_info, label_value)`` rows
(``model/converters.py::LabeledModelDataConverter``), so carrying one
across is a matter of rebuilding the table from plain rows. The port
then serves exactly the coefficients the JAX package serves. The FTRL
state is a pair of vectors, carried as numpy arrays.
"""

from __future__ import annotations

from typing import Any, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..common.mtable import MTable
from ..common.types import AlinkTypes
from ..operator.common.linear.base import (LinearModelData,
                                           LinearModelDataConverter,
                                           LinearModelType)


def _plain(v):
    """A numpy scalar as its Python value; ``None`` stays ``None``."""
    return v.item() if isinstance(v, np.generic) else v


def model_table_from_reference(rows: Iterable[Tuple[Any, Any, Any]],
                               label_type: str = AlinkTypes.STRING) -> MTable:
    """The port's model table from the JAX package's model-table rows,
    given as plain ``(model_id, model_info, label_value)`` tuples (e.g.
    ``table.to_rows()`` on the JAX side). ``label_type`` is the type of
    the JAX table's third column."""
    conv = LinearModelDataConverter(label_type)
    out: List[Tuple] = []
    for model_id, info, label in rows:
        info, label = _plain(info), _plain(label)
        out.append((int(model_id), None if info is None else str(info),
                    label))
    return MTable(out, conv.schema)


def linear_model_from_numpy(coef: np.ndarray, *, has_intercept: bool,
                            label_values: Sequence[Any],
                            vector_col: Optional[str] = None,
                            vector_size: int = 0,
                            feature_names: Optional[Sequence[str]] = None,
                            model_type: str = LinearModelType.LR,
                            label_type: str = AlinkTypes.STRING,
                            model_name: str = "") -> LinearModelData:
    """A :class:`LinearModelData` from a coefficient vector: ``coef`` is
    ``[intercept, w_0, ..., w_{d-1}]`` when ``has_intercept``, else
    ``[w_0, ...]``; ``label_values[0]`` is the positive label. Features
    come from ``vector_col`` (dense or sparse vectors of
    ``vector_size``) or from the numeric columns ``feature_names``."""
    coef = np.asarray(coef, np.float64).reshape(-1)
    if vector_col is None and not feature_names:
        raise ValueError("set vector_col or feature_names")
    n_feat = coef.shape[0] - (1 if has_intercept else 0)
    if vector_col is not None and vector_size and vector_size != n_feat:
        raise ValueError(f"vector_size {vector_size} vs {n_feat} "
                         f"coefficients")
    return LinearModelData(
        model_name=model_name or f"{model_type} model",
        linear_model_type=model_type, has_intercept=bool(has_intercept),
        vector_col=vector_col,
        feature_names=list(feature_names) if feature_names else None,
        vector_size=int(vector_size or n_feat), coef=coef,
        label_values=[_plain(v) for v in label_values],
        label_type=label_type)


def ftrl_state_from_numpy(z: np.ndarray, n: np.ndarray, device,
                          dtype: torch.dtype = torch.float64):
    """The FTRL ``(z, n)`` state as tensors on ``device`` in ``dtype``,
    from numpy arrays (e.g. ``np.asarray`` of the JAX package's state),
    so that both packages can start a step from the same state."""
    return tuple(torch.from_numpy(np.array(a, np.float64)).to(device, dtype)
                 for a in (z, n))


def ftrl_state_to_numpy(z: torch.Tensor, n: torch.Tensor):
    """The FTRL ``(z, n)`` state as numpy arrays on the host."""
    return z.detach().cpu().numpy(), n.detach().cpu().numpy()
