"""Histogram-based tree building on one device.

Counterpart: ``alink_tpu/operator/common/tree/hist.py``: level-wise
growth of a perfect binary tree over quantile-binned features. Trees are
dense arrays (a perfect binary tree of ``max_depth``); unsplit nodes
store feature -1 and route everything left. Generic over a per-sample
stat vector:

  regression  stats (y, y^2, 1)      variance gain
  classify    stats (onehot(y), 1)   gini gain
  gbdt        stats (g, h, 1)        xgboost-style gain g^2/(h+lambda)

The binning (``make_bin_edges``, ``bin_data``, ``bins_to_thresholds``)
and the host descent (``tree_apply_values``) are the JAX package's
numpy, copied. The gain and leaf functions, :func:`build_tree` (with
categorical subset splits) and :func:`tree_apply_binned` are torch ops.
Every level's histogram, and the leaf histogram, is the hand-written
kernel of ``kernels/tree_hist.py`` (the port of the Pallas kernel
``_pallas_level_hist``). The JAX package's fused-histogram modes, its
bf16 one-hot path, its Pallas probe and demotion are not ported: the
port has one path.

The bin prefix sums are taken in float64 along the bin axis and rounded
to float32. PyTorch sums a non-innermost axis sequentially in its
accumulation type on both devices (float64 for float64 input), so the
prefixes are the same bits on the card and on the CPU, and an empty bin
repeats its neighbour's prefix exactly; with the histogram kernel's
fixed order (and ``trainers.py``'s float64 sigmoid) a tree is the same
on both. The JAX package's own ``cumsum`` follows an XLA order that
neither device reproduces, so parity with it is held to its
fused-kernel gate: the same split features and bins, leaf values and
loss within rtol 1e-4. Nothing in a level syncs with the host: the split
choice stays on the device as tensors.

The per-feature importance is not summed on the device: :func:`build_tree`
returns each node's split gain, and :func:`split_importance` adds them on
the host in the JAX package's scatter order.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ....kernels.tree_hist import level_hist
from ..dataproc.quantile import DEVICE_BINNING_MIN_CELLS as _DEVICE_BINNING_MIN_CELLS


# ---------------------------------------------------------------------------
# host-side quantile binning
# ---------------------------------------------------------------------------

def make_bin_edges(X: np.ndarray, n_bins: int,
                   cat_mask: Optional[np.ndarray] = None,
                   device: Optional[bool] = None, env=None) -> np.ndarray:
    """(F, n_bins-1) per-feature quantile cut points (padded with +inf).

    Categorical features (``cat_mask[f]`` True; values must be integer
    category codes) get identity edges 0.5, 1.5, ... so every category is
    its own bin. ``device=None`` selects the device quantile pass
    (dataproc/quantile.py) once n*F reaches ``DEVICE_BINNING_MIN_CELLS``;
    True/False force it.
    """
    n, F = X.shape
    edges = np.full((F, n_bins - 1), np.inf)
    if device is None:
        device = n * F >= _DEVICE_BINNING_MIN_CELLS
    cont = ([f for f in range(F) if not cat_mask[f]]
            if cat_mask is not None else list(range(F)))
    probs = np.linspace(0, 1, n_bins + 1)[1:-1]
    if device and cont:
        from ..dataproc.quantile import distributed_quantiles
        qs_all = distributed_quantiles(
            np.ascontiguousarray(X[:, cont]), probs, env=env)
    for pos, f in enumerate(cont):
        if device:
            qs = qs_all[pos]
        else:
            v = X[:, f]
            v = v[~np.isnan(v)]   # match the device path's per-column NaN
            qs = np.quantile(v, probs) if v.size else np.array([])
        uq = np.unique(qs)
        uq = uq[np.isfinite(uq)]
        edges[f, :len(uq)] = uq
    if cat_mask is not None:
        for f in range(F):
            if cat_mask[f]:
                arity = min(int(X[:, f].max()) + 1, n_bins)
                edges[f, :max(arity - 1, 0)] = (
                    np.arange(max(arity - 1, 0)) + 0.5)
    return edges


def bin_data(X: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """(n, F) int32 bin ids in [0, n_bins)."""
    n, F = X.shape
    out = np.empty((n, F), np.int32)
    for f in range(F):
        e = edges[f]
        out[:, f] = np.searchsorted(e[np.isfinite(e)], X[:, f], side="right")
    return out


# ---------------------------------------------------------------------------
# gain / leaf functions over cumulated stat histograms
# ---------------------------------------------------------------------------

def variance_gain(left, right, total, min_leaf):
    """stats = (sum_y, sum_y2, count): SSE reduction."""
    def sse(s):
        return s[..., 1] - s[..., 0] * s[..., 0] / torch.clamp(s[..., 2],
                                                               min=1e-12)
    ok = (left[..., 2] >= min_leaf) & (right[..., 2] >= min_leaf)
    g = sse(total) - sse(left) - sse(right)
    return torch.where(ok, g, -torch.inf)


def variance_leaf(stats):
    return stats[..., 0] / torch.clamp(stats[..., 2], min=1e-12)


def gini_gain(left, right, total, min_leaf):
    """stats = (c_0..c_{k-1}, count): weighted gini impurity decrease."""
    def imp(s):
        cnt = torch.clamp(s[..., -1], min=1e-12)
        return cnt - (s[..., :-1] * s[..., :-1]).sum(-1) / cnt
    ok = (left[..., -1] >= min_leaf) & (right[..., -1] >= min_leaf)
    g = imp(total) - imp(left) - imp(right)
    return torch.where(ok, g, -torch.inf)


def gini_leaf(stats):
    return stats[..., :-1] / torch.clamp(stats[..., -1:], min=1e-12)


def make_xgb_gain(reg_lambda: float):
    def xgb_gain(left, right, total, min_leaf):
        """stats = (g, h, count)."""
        def score(s):
            return s[..., 0] * s[..., 0] / (s[..., 1] + reg_lambda)
        ok = (left[..., 2] >= min_leaf) & (right[..., 2] >= min_leaf)
        g = 0.5 * (score(left) + score(right) - score(total))
        return torch.where(ok, g, -torch.inf)
    return xgb_gain


def make_xgb_leaf(reg_lambda: float):
    def xgb_leaf(stats):
        return -stats[..., 0] / (stats[..., 1] + reg_lambda)
    return xgb_leaf


# ---------------------------------------------------------------------------
# level-wise tree growth
# ---------------------------------------------------------------------------

def _default_cat_order(hist):
    """Per-(node,feature,bin) ordering score for categorical subset splits:
    first-stat / count ratio. Empty bins sort last so unseen categories
    route right."""
    cnt = hist[..., -1]
    r = hist[..., 0] / torch.clamp(cnt, min=1e-12)
    return torch.where(cnt > 0, r, torch.inf)


def _bin_prefix(hist):
    """Inclusive prefix sums over the bin axis (2) of ``hist`` (nodes, F,
    B, m): float64, sequential on either device, rounded to float32."""
    return torch.cumsum(hist.double(), dim=2).to(hist.dtype)


def _split_search(hist, n_bins: int, gain_fn, min_samples_leaf: float,
                  min_gain: float, feature_mask, cat):
    """The best split of every node of a level from its histogram
    ``hist`` (nodes, F, n_bins, m): prefix sums over the bins, the gain
    of every cut, the argmax. ``cat`` is None or (cat_idx, cat_pos,
    cat_arr, cat_order_fn) for categorical subset splits. Returns the
    level's (features, split bins, gains, LEFT masks); an unsplit node
    has feature -1, bin 0, gain 0 and an empty mask."""
    n_nodes, F, _, m = hist.shape
    dev = hist.device
    cum = _bin_prefix(hist)
    total = cum[:, :, -1:, :]
    left = cum[:, :, :-1, :]                      # split "bin <= b"
    right = total - left
    gains = gain_fn(left, right, total, min_samples_leaf)  # (nodes,F,B-1)
    if cat is not None:
        # sorted-by-score cumulation over ONLY the categorical columns:
        # cut position c sends the first c+1 bins (in score order) left
        cat_idx, cat_pos, cat_arr, cat_order_fn = cat
        hist_c = hist.index_select(1, cat_idx)             # (nodes,Fc,B,m)
        total_c = total.index_select(1, cat_idx)
        order = torch.argsort(cat_order_fn(hist_c), dim=2, stable=True)
        shist = torch.gather(hist_c, 2, order[..., None].expand(-1, -1, -1, m))
        scum = _bin_prefix(shist)
        sleft = scum[:, :, :-1, :]
        sright = total_c - sleft
        sgains = gain_fn(sleft, sright, total_c, min_samples_leaf)
        gains = gains.index_copy(1, cat_idx, sgains)
        # rank[bin] = position of bin in score order
        rank_c = torch.argsort(order, dim=2, stable=True)  # (nodes,Fc,B)
    if feature_mask is not None:
        gains = torch.where(feature_mask[None, :, None] > 0, gains,
                            torch.tensor(-torch.inf, dtype=gains.dtype,
                                         device=dev))
    flat_g = gains.reshape(n_nodes, F * (n_bins - 1))
    best = torch.argmax(flat_g, dim=1)
    best_gain = torch.gather(flat_g, 1, best[:, None])[:, 0]
    best_f = torch.div(best, n_bins - 1, rounding_mode="floor")
    best_b = best - best_f * (n_bins - 1)
    split = best_gain > min_gain
    # LEFT-membership mask per node over bins
    bins_ar = torch.arange(n_bins, device=dev)
    if cat is not None:
        brank = torch.gather(
            rank_c, 1, cat_pos[best_f][:, None, None].expand(
                -1, 1, n_bins))[:, 0, :]                    # (nodes,B)
        pos = torch.where(cat_arr[best_f][:, None], brank, bins_ar[None, :])
    else:
        pos = bins_ar[None, :].expand(n_nodes, n_bins)
    mask = (pos <= best_b[:, None]) & split[:, None]        # (nodes, B)
    return (torch.where(split, best_f, -1).to(torch.int32),
            torch.where(split, best_b, 0).to(torch.int32),
            torch.where(split, best_gain, torch.zeros_like(best_gain)), mask)


def _descend(binned, node_id, feats, masks):
    """Each row's node one level down: right iff its node split and the
    row's bin of the split feature is not in the node's LEFT set."""
    nid = node_id.long()
    nf = feats[nid].long()
    sample_bin = torch.gather(binned, 1, torch.clamp(nf, min=0)[:, None])[:, 0]
    in_left = masks[nid, sample_bin.long()]
    go_right = (nf >= 0) & ~in_left
    return node_id * 2 + go_right.to(torch.int32)


def build_tree(binned, stats, max_depth: int, n_bins: int,
               gain_fn, leaf_fn, min_samples_leaf: float = 1.0,
               min_gain: float = 1e-9, feature_mask=None,
               cat_feats=None, cat_order_fn=None):
    """Grow one tree; returns
    (features, split_bins, split_masks, leaf_values, node_id, leaf_hist,
     gains).

    binned: (n, F) int32 (any strided view; a column-major copy's
    transpose reads fastest); stats: (n, m) float32 — zero rows are
    inert (padding / bagging handled by zeroing stats); feature_mask:
    (F,) 1/0 per-tree column subsample; cat_feats: (F,) bool numpy —
    categorical features split on category *subsets* (bins sorted by
    ``cat_order_fn`` score, then cut like a threshold).

    features/split_bins: (2^max_depth - 1,) level-order;
    split_masks: (2^max_depth - 1, n_bins) bool — per-node LEFT membership
    by bin (continuous nodes encode ``bin <= split_bin``); leaf_values:
    (2^max_depth, ...) from leaf_fn; node_id: (n,) final leaf; gains:
    (2^max_depth - 1,) each node's split gain, 0 where it did not split
    (:func:`split_importance` turns them into the JAX package's
    importance).
    """
    n, F = binned.shape
    dev = stats.device
    node_id = torch.zeros(n, dtype=torch.int32, device=dev)
    cat = None
    if cat_feats is not None and np.asarray(cat_feats, bool).any():
        cat_np = np.asarray(cat_feats, bool)       # static column selection
        cat_pos = np.zeros(F, np.int64)            # F-index -> cat-slice index
        cat_pos[np.flatnonzero(cat_np)] = np.arange(int(cat_np.sum()))
        cat = (torch.from_numpy(np.flatnonzero(cat_np)).to(dev),
               torch.from_numpy(cat_pos).to(dev),
               torch.from_numpy(cat_np).to(dev),
               cat_order_fn or _default_cat_order)
    levels = []
    for level in range(max_depth):
        hist = level_hist(binned, stats, node_id, 1 << level, n_bins)
        levels.append(_split_search(hist, n_bins, gain_fn, min_samples_leaf,
                                    min_gain, feature_mask, cat))
        node_id = _descend(binned, node_id, levels[-1][0], levels[-1][3])

    zero_col = torch.zeros((1, 1), dtype=torch.int32,
                           device=dev).expand(n, 1)
    leaf_hist = level_hist(zero_col, stats, node_id, 1 << max_depth,
                           1)[:, 0, 0, :]
    features, split_bins, gains, split_masks = (
        torch.cat(parts) for parts in zip(*levels))
    return (features, split_bins, split_masks, leaf_fn(leaf_hist), node_id,
            leaf_hist, gains)


def split_importance(features: np.ndarray, gains: np.ndarray, F: int,
                     max_depth: int) -> np.ndarray:
    """(F,) float32 summed split gain per feature over trees (T, nodes):
    within a tree, each level's gains are added in node order into a
    zeroed vector, and the trees' vectors are summed in order — the
    association of the JAX package's ``importance.at[best_f].add`` per
    level and its ``importance + imp`` per tree. An unsplit node adds 0
    at its argmax feature there, a no-op here."""
    features = np.asarray(features).reshape(-1, (1 << max_depth) - 1)
    gains = np.asarray(gains, np.float32).reshape(features.shape)
    total = np.zeros(F, np.float32)
    for tf, tg in zip(features, gains):
        imp = np.zeros(F, np.float32)
        np.add.at(imp, np.maximum(tf, 0), tg)
        total = total + imp
    return total


def tree_apply_binned(binned, features, split_bins, max_depth: int,
                      split_masks=None):
    """Final leaf index for each row, descending the dense tree.

    With ``split_masks`` (n_internal, n_bins) the descent uses the uniform
    LEFT-membership rule (required for categorical splits; identical to
    ``bin <= split_bin`` for continuous nodes)."""
    n = binned.shape[0]
    node = torch.zeros(n, dtype=torch.int64, device=binned.device)
    offset = 0
    for level in range(max_depth):
        gi = offset + node
        f = features[gi].long()
        sample_bin = torch.gather(binned, 1,
                                  torch.clamp(f, min=0)[:, None])[:, 0].long()
        if split_masks is not None:
            in_left = split_masks[gi, sample_bin]
            go_right = (f >= 0) & ~in_left
        else:
            go_right = (f >= 0) & (sample_bin > split_bins[gi])
        node = node * 2 + go_right.long()
        offset += 1 << level
    return node


def bins_to_thresholds(features: np.ndarray, split_bins: np.ndarray,
                       edges: np.ndarray) -> np.ndarray:
    """Real-valued split thresholds for host-side serving: x > thr -> right."""
    thr = np.zeros(features.shape, np.float64)
    for i, (f, b) in enumerate(zip(features, split_bins)):
        thr[i] = edges[int(f), int(b)] if f >= 0 else 0.0
    return thr


def tree_apply_values(X: np.ndarray, features: np.ndarray, thresholds: np.ndarray,
                      max_depth: int, cat_mask: Optional[np.ndarray] = None,
                      split_masks: Optional[np.ndarray] = None) -> np.ndarray:
    """Host/numpy descent on raw feature values.

    Categorical nodes (``cat_mask[f]``) route by LEFT-membership of the
    category code in ``split_masks[node]``; out-of-vocabulary codes route
    right (never in the left set)."""
    n = X.shape[0]
    node = np.zeros(n, np.int64)
    offset = 0
    n_bins = split_masks.shape[1] if split_masks is not None else 0
    for level in range(max_depth):
        gi = offset + node
        f = features[gi].astype(np.int64)
        thr = thresholds[gi]
        x = X[np.arange(n), np.maximum(f, 0)]
        go_right = (f >= 0) & (x > thr)
        if cat_mask is not None and split_masks is not None:
            code = np.round(x).astype(np.int64)
            in_left = np.where(
                code >= 0,
                split_masks[gi, np.clip(code, 0, n_bins - 1)], False)
            is_cat = cat_mask[np.maximum(f, 0)] & (f >= 0)
            go_right = np.where(is_cat, (f >= 0) & ~in_left, go_right)
        node = node * 2 + go_right
        offset += 1 << level
    return node
