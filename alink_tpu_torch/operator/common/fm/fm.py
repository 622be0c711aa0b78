"""Factorization machines.

Counterpart: ``alink_tpu/operator/common/fm/fm.py`` (the re-design of the
reference's common/fm/ FmOptimizer.java: a local adagrad epoch a worker,
then the weighted model average of ``AllReduce(factorAllReduce)``). The
JAX package's ``lax.scan`` of mini-batch adagrad steps becomes a loop on
the session's device, with the same arithmetic:

    s = X V                         (n, k)
    margin = w0 + X w + 0.5 * sum(s^2 - X^2 V^2)
    grad_V = X^T (c s) - (X^2)^T c * V

The dense layout keeps ``torch.matmul`` (the JAX package also computes it
outside any kernel; full float32, TF32 refused). The padded-COO layout's
three scatter-adds (``gw``, ``gV`` and ``sq_c``) are ONE call of the
ordered row scatter-add (``kernels/rows.py::scatter_rows``, "P3") with C =
k + 2 columns ``[val * c, val^2 * c, contrib]``: each column's chain is
independent, so that is bitwise the three separate scatters, in the JAX
package's ``.at[].add`` order. Its plan is built once a training (the
design does not change). A mini-batch's Bernoulli mask comes from
``ComContext.rng()``, not JAX's PRNG: at ``batches_per_epoch=1`` it is all
ones in both packages, and the tests compare the other settings by their
properties.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from ....common.mlenv import MLEnvironment, MLEnvironmentFactory
from ....engine import AllReduce, IterativeComQueue
from ....engine.comqueue import freeze_config
from ....kernels.rows import row_plan, scatter_rows
from ..optim.objfunc import check_full_float32


@dataclass
class FmTrainParams:
    num_factors: int = 10
    learn_rate: float = 0.01
    init_stdev: float = 0.05
    num_epochs: int = 10           # supersteps
    batches_per_epoch: int = 8     # local adagrad steps per superstep
    lambda_0: float = 0.0
    lambda_1: float = 0.0
    lambda_2: float = 0.0
    with_intercept: bool = True
    with_linear_item: bool = True
    is_regression: bool = False
    seed: int = 0


def _fm_margin(data, w0, w, V):
    if "X" in data:
        X = data["X"]
        s = X @ V
        sq = (X ** 2) @ (V ** 2)
        lin = X @ w
    else:
        idx, val = data["idx"], data["val"]
        s = (val[..., None] * V[idx]).sum(1)            # (n, k)
        sq = ((val ** 2)[..., None] * (V ** 2)[idx]).sum(1)
        lin = (val * w[idx]).sum(-1)
    return w0 + lin + 0.5 * (s ** 2 - sq).sum(-1), s


def _fm_grads(data, c, s, V, dim, plan=None):
    """c: dL/dmargin per sample. Returns (g0, gw, gV). ``plan``: the row
    plan of the padded-COO design's keys (:func:`kernels.rows.row_plan`)."""
    g0 = c.sum()
    if "X" in data:
        X = data["X"]
        gw = X.T @ c
        gV = X.T @ (c[:, None] * s) - ((X ** 2).T @ c)[:, None] * V
    else:
        idx, val = data["idx"], data["val"]
        k = V.shape[1]
        vc = val * c[:, None]
        terms = torch.cat([vc[..., None], ((val ** 2) * c[:, None])[..., None],
                           vc[..., None] * s[:, None, :]], -1)  # (n, nnz, k+2)
        acc = torch.zeros((dim, k + 2), dtype=val.dtype, device=val.device)
        scatter_rows(acc, idx.reshape(-1), terms.reshape(-1, k + 2), plan)
        gw, sq_c = acc[:, 0], acc[:, 1]
        gV = acc[:, 2:] - sq_c[:, None] * V
    return g0, gw, gV


def fm_train(data: Dict[str, np.ndarray], dim: int, p: FmTrainParams,
             env: Optional[MLEnvironment] = None):
    """Returns (w0, w, V, loss_curve, steps) as host arrays, trained on
    ``env``'s device in the dtype of ``data["y"]`` (float32 or float64)."""
    dtype = np.asarray(data["y"]).dtype
    if dtype not in (np.float32, np.float64):
        dtype = np.float32
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    k = p.num_factors
    rng = np.random.RandomState(p.seed)
    V0 = (rng.randn(dim, k) * p.init_stdev).astype(dtype)
    eps = 1e-8
    env = env or MLEnvironmentFactory.get_default()

    def dloss(margin, y):
        if p.is_regression:
            return margin - y
        return -y * torch.sigmoid(-y * margin)

    def loss_fn(margin, y):
        if p.is_regression:
            return 0.5 * (margin - y) ** 2
        return torch.logaddexp(torch.zeros_like(margin), -y * margin)

    def local_epoch(ctx):
        dev = ctx.device
        if ctx.is_init_step:
            ctx.put_obj("model", {
                "w0": torch.zeros((), dtype=tdt, device=dev),
                "w": torch.zeros(dim, dtype=tdt, device=dev),
                "V": torch.from_numpy(V0).to(dev),
                "a0": torch.zeros((), dtype=tdt, device=dev),
                "aw": torch.zeros(dim, dtype=tdt, device=dev),
                "aV": torch.zeros((dim, k), dtype=tdt, device=dev)})
            ctx.put_obj("loss_curve", torch.full(
                (p.num_epochs,), float("nan"), dtype=tdt, device=dev))
        shard = {kk: ctx.get_obj(kk) for kk in ("X", "idx", "val", "y", "w")
                 if ctx.contains_obj(kk)}
        if ctx.is_entry_step:
            check_full_float32(shard)
            ctx.put_derived("fm_plan", None if "X" in shard else row_plan(
                shard["idx"].reshape(-1), dim))
        plan = ctx.get_obj("fm_plan")
        n = shard["y"].shape[0]
        m = ctx.get_obj("model")
        gen = ctx.rng()
        prob = torch.full((n,), 1.0 / p.batches_per_epoch, dtype=tdt,
                          device=dev)
        for _ in range(p.batches_per_epoch):
            mask = torch.bernoulli(prob, generator=gen)
            wgt = shard["w"] * mask
            margin, s = _fm_margin(shard, m["w0"], m["w"], m["V"])
            c = wgt * dloss(margin, shard["y"])
            g0, gw, gV = _fm_grads(shard, c, s, m["V"], dim, plan)
            wsum = torch.clamp_min(wgt.sum(), 1e-12)
            g0, gw, gV = g0 / wsum, gw / wsum, gV / wsum
            g0 = g0 + p.lambda_0 * m["w0"]
            gw = gw + p.lambda_1 * m["w"]
            gV = gV + p.lambda_2 * m["V"]
            a0 = m["a0"] + g0 ** 2
            aw = m["aw"] + gw ** 2
            aV = m["aV"] + gV ** 2
            m = {
                "w0": m["w0"] - p.learn_rate * g0 / torch.sqrt(a0 + eps)
                if p.with_intercept else m["w0"],
                "w": m["w"] - p.learn_rate * gw / torch.sqrt(aw + eps)
                if p.with_linear_item else m["w"],
                "V": m["V"] - p.learn_rate * gV / torch.sqrt(aV + eps),
                "a0": a0, "aw": aw, "aV": aV}
        # weighted average across workers (reference factorAllReduce)
        wsum_local = shard["w"].sum()
        scaled = {kk: v * wsum_local for kk, v in m.items()}
        scaled["n"] = wsum_local
        ctx.put_obj("avg", scaled)
        # local loss at the current model for the curve
        margin, _ = _fm_margin(shard, m["w0"], m["w"], m["V"])
        ctx.put_obj("lw", torch.stack([
            (shard["w"] * loss_fn(margin, shard["y"])).sum(), wsum_local]))
        ctx.put_obj("model", m)

    def average(ctx):
        avg = ctx.get_obj("avg")
        n = torch.clamp_min(avg["n"], 1e-12)
        model = ctx.get_obj("model")
        ctx.put_obj("model", {kk: avg[kk] / n for kk in model.keys()})
        lw = ctx.get_obj("lw")
        curve = ctx.get_obj("loss_curve")
        curve[ctx.step_no - 1] = lw[0] / torch.clamp_min(lw[1], 1e-12)

    queue = (IterativeComQueue(env=env, max_iter=p.num_epochs, seed=p.seed)
             .add(local_epoch)
             .add(AllReduce("avg"))
             .add(AllReduce("lw"))
             .add(average))
    for kk, v in data.items():
        queue.init_with_partitioned_data(kk, v)
    # V0 is a function of (seed, dim, num_factors, init_stdev, dtype)
    queue.set_program_key(("fm", dim, str(dtype), freeze_config(p)))
    res = queue.exec()
    model = res.get("model")
    curve = np.asarray(res.get("loss_curve"))
    return (np.asarray(model["w0"]), np.asarray(model["w"]),
            np.asarray(model["V"]), curve[~np.isnan(curve)], res.step_count)


def fm_predict_margin(w0, w, V, design: Dict) -> np.ndarray:
    """Host float64 margins (the JAX package's numpy, copied)."""
    if design["kind"] == "dense":
        X = design["X"]
        s = X @ V
        sq = (X ** 2) @ (V ** 2)
        return w0 + X @ w + 0.5 * (s ** 2 - sq).sum(-1)
    idx, val = design["idx"], design["val"]
    s = (val[..., None] * V[idx]).sum(1)
    sq = ((val ** 2)[..., None] * (V ** 2)[idx]).sum(1)
    lin = (val * w[idx]).sum(-1)
    return w0 + lin + 0.5 * (s ** 2 - sq).sum(-1)
