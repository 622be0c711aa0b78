"""Tree trainers on the BSP engine, at one worker.

Counterpart: ``alink_tpu/operator/common/tree/trainers.py``:

  GBDT  — histogram boosting, one tree per superstep
  RF    — bagging by per-tree weight masks + feature column subsampling
  DecisionTree — RF with one tree, no subsampling.

Both trainers run on :class:`~alink_tpu_torch.engine.IterativeComQueue`
in float32, as the JAX package does. The tree arrays live in the carry
on the session's device and are fetched to the host once, when the
queue ends. The binned table is copied once per training into a
column-major (F, n) tensor, so each feature's column is contiguous for
the histogram kernel at every level of every tree.

Randomness (row bagging, feature subsampling) draws from the engine's
per-step ``torch.Generator`` (``ComContext.rng``): the same seed gives
the same forest on one device, but not the JAX package's draws. Several
workers, and with them the ensemble mode's row shuffle, wait for the
multi-GPU slice: the engine's environment refuses ``parallelism > 1``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ....common.mlenv import MLEnvironment, MLEnvironmentFactory
from ....engine import IterativeComQueue
from ....engine.communication import manifest_psum
from .hist import (bin_data, build_tree, gini_gain, gini_leaf, make_bin_edges,
                   make_xgb_gain, make_xgb_leaf, split_importance,
                   variance_gain, variance_leaf)


def _feature_subsample_mask(gen: torch.Generator, F: int, ratio: float,
                            dtype, device) -> torch.Tensor:
    """Exactly ``max(1, round(ratio * F))`` features survive, chosen
    uniformly per tree (the reference's featureSubsamplingRatio and
    sklearn's ``max_features`` semantics)."""
    kf = max(1, int(round(ratio * F)))
    u = torch.rand(F, generator=gen, device=device)
    thr = torch.sort(u).values[kf - 1]
    return (u <= thr).to(dtype)


@dataclass
class TreeTrainParams:
    num_trees: int = 100
    max_depth: int = 5
    n_bins: int = 64
    learning_rate: float = 0.3         # gbdt shrinkage
    min_samples_leaf: int = 1
    reg_lambda: float = 1.0            # gbdt leaf regularization
    subsample_ratio: float = 1.0       # bagging row fraction
    feature_subsample_ratio: float = 1.0
    seed: int = 0


def _put_tree(ctx, t: int, tf, tb, tm, tv, tg) -> None:
    """Store tree ``t``'s arrays in the carry's (T, ...) slots, in place."""
    for name, v in (("trees_f", tf), ("trees_b", tb), ("trees_m", tm),
                    ("trees_v", tv), ("trees_g", tg)):
        ctx.get_obj(name)[t] = v


def _alloc_trees(ctx, T: int, d: int, n_bins: int, leaf_shape) -> None:
    n_internal = (1 << d) - 1
    dev = ctx.device
    ctx.put_obj("trees_f", torch.zeros((T, n_internal), dtype=torch.int32,
                                       device=dev))
    ctx.put_obj("trees_b", torch.zeros((T, n_internal), dtype=torch.int32,
                                       device=dev))
    ctx.put_obj("trees_v", torch.zeros((T,) + leaf_shape,
                                       dtype=torch.float32, device=dev))
    ctx.put_obj("trees_m", torch.zeros((T, n_internal, n_bins),
                                       dtype=torch.bool, device=dev))
    ctx.put_obj("trees_g", torch.zeros((T, n_internal), dtype=torch.float32,
                                       device=dev))
    # column-major copy of the binned table, once per training
    ctx.put_obj("binned_t", ctx.get_obj("binned").t().contiguous())


def gbdt_train(X: np.ndarray, y: np.ndarray, p: TreeTrainParams,
               is_regression: bool, env: Optional[MLEnvironment] = None,
               sample_weight: Optional[np.ndarray] = None,
               cat_mask: Optional[np.ndarray] = None):
    """Returns (features (T, 2^d-1), split_bins, split_masks
    (T, 2^d-1, n_bins), leaf_values (T, 2^d), edges, base_score,
    loss_curve, importance (F,)), as numpy arrays.

    ``cat_mask``: (F,) bool — categorical columns (integer category codes)
    bin by identity and split on category subsets (hist.build_tree).

    The classification gradient's sigmoid is taken in float64 and
    rounded to float32, so that the card and the CPU give the same
    gradients (their float32 ``exp`` differ in the last bits)."""
    n, F = X.shape
    dtype = np.float32
    env = env or MLEnvironmentFactory.get_default()
    edges = make_bin_edges(X, p.n_bins, cat_mask, env=env)
    binned = bin_data(X, edges)
    w = np.ones(n, dtype) if sample_weight is None else np.asarray(sample_weight, dtype)
    y = np.asarray(y, dtype)
    base = float((y * w).sum() / max(w.sum(), 1e-12)) if is_regression else 0.0
    d = p.max_depth
    T = p.num_trees
    gain_fn = make_xgb_gain(p.reg_lambda)
    leaf_fn = make_xgb_leaf(p.reg_lambda)
    n_leaves = 1 << d

    def cat_order(h_):
        return torch.where(h_[..., 1] > 0,
                           h_[..., 0] / (h_[..., 1] + p.reg_lambda),
                           torch.inf)

    def grow(ctx):
        if ctx.is_init_step:
            nloc = ctx.get_obj("binned").shape[0]
            ctx.put_obj("F", torch.full((nloc,), base, dtype=torch.float32,
                                        device=ctx.device))
            _alloc_trees(ctx, T, d, p.n_bins, (n_leaves,))
            ctx.put_obj("loss_curve", torch.zeros((T,), dtype=torch.float32,
                                                  device=ctx.device))
        yl = ctx.get_obj("y")
        wl = ctx.get_obj("w")
        Fcur = ctx.get_obj("F")
        if is_regression:
            g = (Fcur - yl) * wl
            h = wl
            loss = 0.5 * ((Fcur - yl) ** 2 * wl).sum()
        else:
            prob = torch.sigmoid(Fcur.double()).float()
            g = (prob - yl) * wl           # y in {0,1}
            h = torch.clamp(prob * (1 - prob), min=1e-6) * wl
            loss = (wl * (torch.logaddexp(torch.zeros_like(Fcur), Fcur)
                          - yl * Fcur)).sum()
        # bagging + feature subsample, per tree
        gen = ctx.rng()
        if p.subsample_ratio < 1.0:
            bag = (torch.rand(g.shape, generator=gen, device=ctx.device)
                   < p.subsample_ratio).to(g.dtype)
            g = g * bag
            h = h * bag
            wb = wl * bag
        else:
            wb = wl
        fmask = _feature_subsample_mask(
            gen, F, p.feature_subsample_ratio, torch.float32,
            ctx.device) if p.feature_subsample_ratio < 1.0 else None
        stats = torch.stack([g, h, wb], dim=1)
        tf, tb, tm, tv, node_id, _, tg = build_tree(
            ctx.get_obj("binned_t").t(), stats, d, p.n_bins, gain_fn,
            leaf_fn, min_samples_leaf=float(p.min_samples_leaf),
            feature_mask=fmask, cat_feats=cat_mask, cat_order_fn=cat_order)
        t = ctx.step_no - 1
        _put_tree(ctx, t, tf, tb, tm, tv, tg)
        ctx.put_obj("F", Fcur + p.learning_rate * tv[node_id.long()])
        lw = manifest_psum(torch.stack([loss, wl.sum()]), "d",
                           name="gbdt_loss", num_workers=ctx.num_task)
        ctx.get_obj("loss_curve")[t] = lw[0] / torch.clamp(lw[1], min=1e-12)

    res = (IterativeComQueue(env=env, max_iter=T, seed=p.seed)
           .init_with_partitioned_data("binned", binned)
           .init_with_partitioned_data("y", y)
           .init_with_partitioned_data("w", w)
           .add(grow)
           .exec())
    tf = res.get("trees_f")
    importance = split_importance(tf, res.get("trees_g"), F, d)
    return (tf, res.get("trees_b"), res.get("trees_m"), res.get("trees_v"),
            edges, base, res.get("loss_curve"), importance)


def forest_train(X: np.ndarray, y_stats: np.ndarray, p: TreeTrainParams,
                 kind: str, env: Optional[MLEnvironment] = None,
                 cat_mask: Optional[np.ndarray] = None):
    """Random forest / decision tree. ``y_stats``: (n, m) per-sample stats —
    (onehot(y), 1) for classification (kind="gini") or (y, y^2, 1) for
    regression (kind="variance"). Returns (features, split_bins,
    split_masks, leaf_values (T, 2^d, ...), edges, importance (F,)), as
    numpy arrays."""
    n, F = X.shape
    dtype = np.float32
    env = env or MLEnvironmentFactory.get_default()
    edges = make_bin_edges(X, p.n_bins, cat_mask, env=env)
    binned = bin_data(X, edges)
    d = p.max_depth
    T = p.num_trees
    m = y_stats.shape[1]
    gain_fn = gini_gain if kind == "gini" else variance_gain
    leaf_fn = gini_leaf if kind == "gini" else variance_leaf
    n_leaves = 1 << d
    leaf_shape = (n_leaves, m - 1) if kind == "gini" else (n_leaves,)

    def grow(ctx):
        if ctx.is_init_step:
            _alloc_trees(ctx, T, d, p.n_bins, leaf_shape)
        stats = ctx.get_obj("stats")
        gen = ctx.rng()
        if p.subsample_ratio < 1.0:
            bag = (torch.rand(stats.shape[0], generator=gen,
                              device=ctx.device)
                   < p.subsample_ratio).to(stats.dtype)
            stats = stats * bag[:, None]
        fmask = _feature_subsample_mask(
            gen, F, p.feature_subsample_ratio, torch.float32,
            ctx.device) if p.feature_subsample_ratio < 1.0 else None
        tf, tb, tm, tv, _, _, tg = build_tree(
            ctx.get_obj("binned_t").t(), stats, d, p.n_bins, gain_fn,
            leaf_fn, min_samples_leaf=float(p.min_samples_leaf),
            feature_mask=fmask, cat_feats=cat_mask)
        _put_tree(ctx, ctx.step_no - 1, tf, tb, tm, tv, tg)

    res = (IterativeComQueue(env=env, max_iter=T, seed=p.seed)
           .init_with_partitioned_data("binned", binned)
           .init_with_partitioned_data("stats", y_stats.astype(dtype))
           .add(grow)
           .exec())
    tf = res.get("trees_f")
    importance = split_importance(tf, res.get("trees_g"), F, d)
    return (tf, res.get("trees_b"), res.get("trees_m"), res.get("trees_v"),
            edges, importance)
