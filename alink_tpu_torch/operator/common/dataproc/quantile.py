"""Device quantiles, all columns at once, in one superstep.

Counterpart: ``alink_tpu/operator/common/dataproc/quantile.py`` (the
re-design of the reference's ``SortUtils.pSort`` quantiles). One
superstep on the session's device takes each column's min and
max, then a fixed-grid histogram of ``fine_bins`` cells per column; the
small (F, fine_bins) table goes to the host once and the quantiles come
from the cumulative counts with linear interpolation inside cells (the
host part is the JAX package's numpy, copied).

The histogram is an integer count, so ``torch.bincount`` is exact in
any order: the card, the CPU and the JAX package give the same table
whenever the cell ids agree, and the cell ids are the same float64
arithmetic in all three.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ....common.mlenv import MLEnvironment
from ....engine import IterativeComQueue
from ....engine.communication import manifest_pmax, manifest_pmin

# n*F at or above this: quantile/bin on device (one sharded pass) instead of
# per-column host numpy — shared by tree binning (tree/hist.py) and
# QuantileDiscretizerTrainBatchOp so the cutover is tuned in one place
DEVICE_BINNING_MIN_CELLS = 2_000_000


def distributed_quantiles(X: np.ndarray, probs: np.ndarray,
                          env: Optional[MLEnvironment] = None,
                          fine_bins: int = 8192) -> np.ndarray:
    """(F, len(probs)) per-column quantile values of ``X`` (n, F).

    NaNs are excluded per column (matching np.quantile on the non-NaN
    subset). Columns that are entirely NaN/empty return NaN (callers drop
    non-finite cut points).
    """
    X = np.asarray(X)
    F = X.shape[1]
    probs = np.asarray(probs, np.float64)

    def stage(ctx):
        Xb = ctx.get_obj("X")
        valid = ~torch.isnan(Xb)
        big = torch.where(valid, Xb, -torch.inf).amax(0)
        small = torch.where(valid, Xb, torch.inf).amin(0)
        mx = manifest_pmax(big, ctx.AXIS, name="quantile_max",
                           num_workers=ctx.num_task)
        mn = manifest_pmin(small, ctx.AXIS, name="quantile_min",
                           num_workers=ctx.num_task)
        span = torch.clamp(mx - mn, min=1e-300)
        b = torch.clamp(((Xb - mn) / span * fine_bins).to(torch.int32),
                        0, fine_bins - 1)
        flat = (torch.arange(F, dtype=torch.int64, device=Xb.device)[None, :]
                * fine_bins + b)
        hist = torch.bincount(flat[valid], minlength=F * fine_bins)
        ctx.put_obj("hist", ctx.all_reduce_sum(hist))
        ctx.put_obj("mn", mn)
        ctx.put_obj("mx", mx)

    res = (IterativeComQueue(env=env, max_iter=1)
           .init_with_partitioned_data("X", X)
           .add(stage)
           .exec())
    hist = np.asarray(res.get("hist"), np.float64).reshape(F, fine_bins)
    mn = np.asarray(res.get("mn"), np.float64)
    mx = np.asarray(res.get("mx"), np.float64)
    span = mx - mn

    cum = np.cumsum(hist, axis=1)                     # (F, K)
    total = cum[:, -1]                                # non-NaN count per col
    out = np.full((F, len(probs)), np.nan)
    ok = (total > 0) & np.isfinite(span)
    targets = np.outer(total, probs)                  # (F, q)
    for_cols = np.where(ok)[0]
    if for_cols.size:
        # cell index where the cumulative count reaches the target
        idx = np.stack([np.searchsorted(cum[f], targets[f], side="left")
                        for f in for_cols])
        idx = np.clip(idx, 0, fine_bins - 1)
        csel = cum[for_cols]
        prev = np.where(idx > 0,
                        np.take_along_axis(csel, np.maximum(idx - 1, 0), 1), 0.0)
        cell = np.take_along_axis(hist[for_cols], idx, 1)
        frac = np.where(cell > 0,
                        (targets[for_cols] - prev) / np.maximum(cell, 1e-300),
                        0.0)
        vals = (mn[for_cols, None]
                + (idx + np.clip(frac, 0.0, 1.0)) / fine_bins
                * span[for_cols, None])
        out[for_cols] = np.clip(vals, mn[for_cols, None], mx[for_cols, None])
    return out
