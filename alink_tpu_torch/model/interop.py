"""Carry a linear model, an FTRL state, a tree model or a fitted pipeline
across from the JAX package or from numpy arrays.

No counterpart module in ``alink_tpu``: both packages store a linear
model as the same table of ``(model_id, model_info, label_value)`` rows
(``model/converters.py::LabeledModelDataConverter``), so carrying one
across is a matter of rebuilding the table from plain rows. The port
then serves exactly the coefficients the JAX package serves. The FTRL
state is a pair of vectors, carried as numpy arrays. A tree model is
built from a trainer's arrays (``gbdt_train`` / ``forest_train`` of
either package), the way the tree train ops build theirs. A fitted
pipeline saved by the JAX package (``PipelineModel.save``, the
``"alink_tpu.pipeline.v1"`` JSON) loads as the port's ``PipelineModel``:
every stage class maps to the port's class of the same module path and
name, and its model table comes through ``MTable.from_json_rows``. The
FM and LDA model tables are both packages' ``(model_id, model_info)``
rows of the simple converter, carried by
:func:`simple_model_table_from_reference`, or built from a trainer's
arrays (:func:`fm_model_from_numpy`, :func:`lda_model_from_numpy`); the
Word2Vec table's ``(word, vec)`` rows by
:func:`word2vec_table_from_reference` or :func:`word2vec_model_from_numpy`.
A table the port saves loads in the JAX package from its rows the same
way (``MTable(table.to_rows(), schema)`` there), bit for bit.
"""

from __future__ import annotations

import json
from typing import Any, Iterable, List, Optional, Sequence, Tuple, Union

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


def tree_model_from_numpy(algo: str, features: np.ndarray,
                          split_bins: np.ndarray, leaf_values: np.ndarray,
                          edges: np.ndarray, *, is_regression: bool,
                          max_depth: int, labels: Sequence[Any] = (),
                          base_score: float = 0.0, learning_rate: float = 1.0,
                          split_masks: Optional[np.ndarray] = None,
                          importances: Optional[np.ndarray] = None,
                          feature_cols: Optional[Sequence[str]] = None,
                          vector_col: Optional[str] = None,
                          label_type: str = AlinkTypes.STRING,
                          cat_cols: Optional[Sequence[str]] = None,
                          cat_vocabs: Optional[dict] = None):
    """The port's ``TreeModelData`` from a tree trainer's outputs:
    ``features`` and ``split_bins`` (T, 2^d - 1), ``leaf_values``
    (T, 2^d[, k]), the bin ``edges`` (F, n_bins - 1) that turn split bins
    into thresholds, and the optional ``split_masks`` (T, 2^d - 1,
    n_bins) and ``importances`` (F,). ``algo`` is ``"gbdt"`` (with its
    ``base_score`` and ``learning_rate``) or ``"rf"``."""
    from ..operator.batch.classification.tree_ops import TreeModelData
    from ..operator.common.tree.hist import bins_to_thresholds
    features = np.asarray(features)
    split_bins = np.asarray(split_bins)
    thr = np.stack([bins_to_thresholds(features[i], split_bins[i], edges)
                    for i in range(features.shape[0])])
    return TreeModelData(
        algo, bool(is_regression), int(max_depth), features, thr,
        np.asarray(leaf_values), float(base_score), float(learning_rate),
        [_plain(v) for v in labels],
        list(feature_cols) if feature_cols else None, vector_col, label_type,
        split_masks=None if split_masks is None else np.asarray(split_masks),
        cat_cols=list(cat_cols) if cat_cols else None, cat_vocabs=cat_vocabs,
        importances=None if importances is None else np.asarray(importances))


_REFERENCE = "alink_tpu."


def pipeline_model_from_reference(obj_or_path: Union[str, dict]):
    """The port's ``PipelineModel`` from a pipeline the JAX package saved:
    the path of its file, or the file's parsed JSON. Each stage class
    ``alink_tpu.<module>.<Class>`` becomes ``alink_tpu_torch.<module>.
    <Class>`` (nothing of ``alink_tpu`` is imported); a class the port
    lacks raises ``ValueError``."""
    from ..pipeline.base import stages_from_json
    obj = obj_or_path
    if not isinstance(obj, dict):
        with open(obj_or_path, "r", encoding="utf-8") as f:
            obj = json.load(f)

    def rename(name: str) -> str:
        if not name.startswith(_REFERENCE):
            raise ValueError(f"stage class {name!r} is not a class of "
                             f"alink_tpu")
        return "alink_tpu_torch." + name[len(_REFERENCE):]

    return stages_from_json(obj, rename)


def simple_model_table_from_reference(rows: Iterable[Tuple[Any, Any]]
                                      ) -> MTable:
    """The port's table of a simple-converter model (FM, LDA, ALS, ...)
    from the JAX package's ``(model_id, model_info)`` rows (e.g.
    ``table.to_rows()`` on the JAX side)."""
    from .converters import SimpleModelDataConverter
    return MTable([(int(_plain(i)), str(_plain(info))) for i, info in rows],
                  SimpleModelDataConverter.SCHEMA)


def fm_model_from_numpy(w0: float, w: np.ndarray, V: np.ndarray, *,
                        is_regression: bool,
                        label_values: Sequence[Any] = (),
                        vector_col: Optional[str] = None,
                        feature_cols: Optional[Sequence[str]] = None,
                        label_type: str = AlinkTypes.STRING) -> MTable:
    """An FM model table from an FM trainer's arrays (``fm_train`` of
    either package): ``w0``, ``w`` (dim,), ``V`` (dim, k);
    ``label_values[0]`` is the positive label."""
    from ..operator.batch.classification.fm_ops import (FmModelData,
                                                        FmModelDataConverter)
    return FmModelDataConverter().save_model(FmModelData(
        float(w0), np.asarray(w, np.float64), np.asarray(V, np.float64),
        bool(is_regression), vector_col,
        list(feature_cols) if feature_cols else None,
        [_plain(v) for v in label_values], label_type))


def lda_model_from_numpy(gamma: np.ndarray, alpha, beta: float,
                         vocab: Sequence[str], method: str = "em",
                         log_likelihood: float = 0.0,
                         log_perplexity: float = 0.0) -> MTable:
    """An LDA model table from the ``(V + 1, k)`` ``gamma`` layout (the
    word-topic counts with the topic totals last), the alpha vector (or
    one value), beta, the vocabulary and the method (``em`` or
    ``online``)."""
    from ..operator.batch.clustering.lda_ops import (LdaModelData,
                                                     LdaModelDataConverter)
    gamma = np.asarray(gamma, np.float64)
    k = gamma.shape[1]
    a = np.asarray(alpha, np.float64)
    return LdaModelDataConverter().save_model(LdaModelData(
        k, list(vocab), gamma, np.full((k,), float(a)) if a.ndim == 0 else a,
        float(beta), method, float(log_likelihood), float(log_perplexity)))


def word2vec_model_from_numpy(vocab: Sequence[str],
                              vectors: np.ndarray) -> MTable:
    """A Word2Vec model table, ``(word, vec)`` rows, from a trainer's
    vocabulary and (V, D) vectors."""
    from ..operator.common.nlp.word2vec import word2vec_model_table
    return word2vec_model_table(list(vocab), np.asarray(vectors))


def word2vec_table_from_reference(rows: Iterable[Tuple[Any, Any]]) -> MTable:
    """The port's Word2Vec table from the JAX package's ``(word, vec)``
    rows: each vector (the JAX package's ``DenseVector`` or an array)
    becomes the port's ``DenseVector`` of the same float64 values."""
    words, vecs = [], []
    for word, vec in rows:
        words.append(str(_plain(word)))
        vecs.append(np.asarray(getattr(vec, "data", vec), np.float64))
    return word2vec_model_from_numpy(words, np.asarray(vecs).reshape(
        len(words), -1))
