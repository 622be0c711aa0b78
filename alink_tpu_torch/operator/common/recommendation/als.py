"""ALS matrix factorization on the one-worker BSP engine.

Counterpart: ``alink_tpu/operator/common/recommendation/als.py`` (the
re-design of the reference's common/recommendation/AlsTrain.java: user
and item blocks exchanging factor requests over Flink coGroups,
per-block Cholesky solves of the normal equations inside a loop of
``numIters * 2`` supersteps). The arithmetic is the JAX package's, op
for op, in float32:

* each worker's rating rows are sorted by the side's id once on the
  host (the ids never change), so every id owns a contiguous run;
* a half-sweep gathers the other side's factors and builds the
  contribution block ``[ww * x_i * x_j (packed lower triangle),
  bval * x, w]``, K = r(r+1)/2 + r + 1 columns (66 at rank 10);
* a run's sums are the difference of two prefix sums. The prefix is
  two-level (float32 ``cumsum`` within 512-row blocks and over the
  block sums) and mean-centred: the per-column mean is subtracted
  before the scans, so the prefix is a zero-drift walk and float32
  keeps about 1e-6 relative, and ``mean * run_length`` is added back
  per run;
* the run sums are written at the runs' ids into a zeroed (n, K)
  buffer (unique ids at one worker: ``index_copy_``, no atomics), the
  reductions are the identity at one worker, the packed triangle is
  unpacked, ridge ``lambda * max(cnt, 1) * I`` added and the systems
  solved by ``ops/smallsolve.py::batched_spd_solve`` (FISTA's
  :func:`batched_nnls` after it when ``nonnegative``); cold ids get 0;
* a superstep runs both half-sweeps, then the training RMSE over the
  user-sorted copy into ``rmse_curve``; ``tol > 0`` stops when the RMSE
  moves less than ``tol`` after a burn-in of ``min(4, num_iter)``
  supersteps, and the returned curve's length is the measured count.

The port's one difference is where the block lives: the contributions
are written straight into the zero-padded (blocks x 512, K) buffer and
centred and scanned in place, where the JAX package concatenates,
pads and allocates a centred copy; the values are the same. The
product inside the solve runs in full float32 on the card: a training
raises while ``torch.backends.cuda.matmul.allow_tf32`` is on
(``objfunc.check_full_float32``). Every op of a superstep is a PyTorch
op on the session's device (no TPU kernel lies on this path; the JAX
package computes it in XLA ops); the stages are module functions, so
they can be timed one by one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ....common.mlenv import MLEnvironment, MLEnvironmentFactory
from ....engine import IterativeComQueue
from ....engine.comqueue import freeze_config
from ....engine.communication import (manifest_all_gather, manifest_psum,
                                      manifest_psum_scatter)
from ....ops.smallsolve import batched_spd_solve
from ..optim.objfunc import check_full_float32

PREFIX_BLOCK = 512          # rows of one in-block cumsum (the JAX package's C)


def _fista_momenta(num_iter: int, dtype: torch.dtype):
    """FISTA's momentum coefficients ``(t - 1) / t_new`` of each
    iteration, ``t`` from 1 by ``t_new = (1 + sqrt(1 + 4 t^2)) / 2`` in
    ``dtype``'s precision (the JAX package carries the same scalar on
    the device). They depend on the iteration only, so they are Python
    floats here and no scalar op reaches the card."""
    f = np.float64 if dtype == torch.float64 else np.float32
    t = f(1.0)
    out = []
    for _ in range(num_iter):
        t_new = f(0.5) * (f(1.0) + np.sqrt(f(1.0) + f(4.0) * t * t))
        out.append(float((t - f(1.0)) / t_new))
        t = t_new
    return out


def batched_nnls(A, b, x0=None, num_iter: int = 80):
    """Batched nonnegative least squares: min_x>=0  1/2 x^T A x - b^T x.

    The reference's NNLSSolver (projected-gradient NNLS of ALS'
    nonnegative mode) as accelerated projected gradient (FISTA) with a
    per-row Lipschitz bound ``L = trace(A)`` (valid since A is PSD), a
    fixed ``num_iter`` iterations of tensor ops (the JAX package's
    ``fori_loop``). ``A``: (n, r, r) PSD, ``b``: (n, r); ``x0`` a warm
    start (zeros if omitted)."""
    L = torch.clamp(torch.diagonal(A, dim1=-2, dim2=-1).sum(-1),
                    min=1e-12)[:, None]
    x = torch.zeros_like(b) if x0 is None else x0
    y = x
    for mom in _fista_momenta(num_iter, b.dtype):
        grad = torch.einsum("nij,nj->ni", A, y) - b
        x_new = torch.clamp(y - grad / L, min=0.0)
        y = x_new + mom * (x_new - x)
        x = x_new
    return x


@dataclass
class AlsTrainParams:
    rank: int = 10
    num_iter: int = 10
    lambda_reg: float = 0.1
    implicit_prefs: bool = False
    alpha: float = 40.0
    nonnegative: bool = False
    seed: int = 0
    tol: float = 0.0          # train-RMSE delta early stop; 0 = run num_iter
    # Shard the post-reduction normal equations + solve by id range
    # (reduce_scatter instead of psum), then all_gather only the solved
    # factors. At one worker both collectives are the identity.
    shard_solve: bool = False


def _sorted_side(ids: np.ndarray, rw: np.ndarray, col: int):
    """Sort one worker's rating rows by the side's id column and emit the
    per-id run boundaries. ``ids`` (L, 2) int32, ``rw`` (L, 2) float32
    [rating, weight]. Returns (sorted_ids, sorted_rw, (id, start, end))."""
    order = np.argsort(ids[:, col], kind="stable")
    si, sr = ids[order], rw[order]
    uniq, starts, counts = np.unique(si[:, col], return_index=True,
                                     return_counts=True)
    plan = np.stack([uniq, starts, starts + counts], 1).astype(np.int32)
    return si, sr, plan


# -- the stages of a half-sweep ----------------------------------------------

def contributions(other_factors, bids, brw, other_col: int, il, jl,
                  p: AlsTrainParams, block: int = PREFIX_BLOCK):
    """The gather of the other side's factors and the contribution block
    ``[ww * x_i * x_j (packed tril), bval * x, w]`` of every rating row,
    written into a zeroed (ceil(L / block) * block, K) buffer: the
    prefix's padded layout."""
    r = brw[:, 0]
    w = brw[:, 1]
    x = other_factors.index_select(0, bids[:, other_col])      # (L, rank)
    if p.implicit_prefs:
        c = 1.0 + p.alpha * torch.abs(r)
        pref = (r > 0).to(x.dtype)
        ww = c * w
        bval = c * pref * w
    else:
        ww = w
        bval = r * w
    n, rank = x.shape
    n_tri = il.shape[0]
    rows = -(-max(n, 1) // block) * block
    cpad = torch.zeros((rows, n_tri + rank + 1), dtype=x.dtype,
                       device=x.device)
    tri = cpad[:n, :n_tri]
    torch.mul(x.index_select(1, il), x.index_select(1, jl), out=tri)
    tri.mul_(ww[:, None])
    torch.mul(bval[:, None], x, out=cpad[:n, n_tri:n_tri + rank])
    cpad[:n, -1] = w
    return cpad


def prefix_sums(cpad, block: int = PREFIX_BLOCK):
    """The mean-centred two-level prefix of the padded contribution
    block, in place: returns (intra (blocks * block, K): in-block
    inclusive cumsums of the centred rows, inter (blocks + 1, K): the
    exclusive cumsum of the block totals, mean (K,))."""
    K = cpad.shape[1]
    blk = cpad.view(-1, block, K)
    mean = blk.sum(dim=1).sum(dim=0) / (blk.shape[0] * block)
    blk.sub_(mean)
    blk.cumsum_(dim=1)
    inter = torch.cat([cpad.new_zeros((1, K)),
                       torch.cumsum(blk[:, -1, :], dim=0)], dim=0)
    return cpad, inter, mean


def run_slots(intra, inter, mean, plan, n_rows: int,
              block: int = PREFIX_BLOCK):
    """Each run's sums, ``prefix(end) - prefix(start) + mean * span``,
    written at the run's id into a zeroed (n_rows, K) buffer. ``plan``
    (N, 3) int32 rows of (id, start, end)."""
    ids_ = plan[:, 0]
    starts = plan[:, 1].long()
    ends = plan[:, 2].long()

    def prefix(t):
        # intra's row t - 1 is the in-block sum through t - 1 when t is
        # not a block's first row; at a block start the part is 0
        part = torch.where((t % block > 0)[:, None],
                           intra.index_select(0, torch.clamp(t - 1, min=0)),
                           0.0)
        return inter.index_select(0, t // block) + part

    span = (ends - starts).to(intra.dtype)[:, None]
    slot = (prefix(ends) - prefix(starts)) + mean * span
    return intra.new_zeros((n_rows, intra.shape[1])).index_copy_(
        0, ids_.long(), slot)


def solve_normal(A, b, cnt, unpack, eye, p: AlsTrainParams):
    """Unpack the packed lower triangles, add the ridge ``lambda *
    max(cnt, 1) * I``, solve (and project by FISTA when
    ``nonnegative``); ids with no rating get 0."""
    rank = p.rank
    A = A.index_select(1, unpack).reshape(A.shape[0], rank, rank)
    A = A + p.lambda_reg * torch.clamp(cnt, min=1.0)[:, None, None] * eye
    sol = batched_spd_solve(A, b)
    if p.nonnegative:
        sol = batched_nnls(A, b, x0=torch.clamp(sol, min=0.0))
    return torch.where(cnt[:, None] > 0, sol, 0.0)


def train_rmse(uf, if_, bids, brw):
    """The weighted training RMSE over the rating rows (float32)."""
    pred = (uf.index_select(0, bids[:, 0])
            * if_.index_select(0, bids[:, 1])).sum(-1)
    r = brw[:, 0]
    w = brw[:, 1]
    se = manifest_psum(torch.stack([(w * (pred - r) ** 2).sum(), w.sum()]),
                       "d", name="als_rmse")
    return torch.sqrt(se[0] / torch.clamp(se[1], min=1e-12)).to(
        torch.float32)


def als_train(users: np.ndarray, items: np.ndarray, ratings: np.ndarray,
              p: AlsTrainParams, env: Optional[MLEnvironment] = None,
              num_users: Optional[int] = None, num_items: Optional[int] = None,
              dtype: torch.dtype = torch.float32
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (user_factors (U, rank), item_factors (I, rank), rmse_curve)
    as host arrays (the factors in ``dtype``, the curve float32);
    ``len(rmse_curve)`` is the measured number of iterations run. Runs on
    ``env``'s device (the default session's when none is given).
    ``dtype``: float32, the JAX package's arithmetic; float64 runs the
    same ops from the same (float32) initial draws, to tell float32
    rounding from a fault (card against CPU)."""
    env = env or MLEnvironmentFactory.get_default()
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"dtype {dtype}: want torch.float32 or "
                         f"torch.float64")
    fdt = np.float64 if dtype == torch.float64 else np.float32
    users = np.asarray(users, np.int32)
    items = np.asarray(items, np.int32)
    ratings = np.asarray(np.asarray(ratings, np.float32), fdt)
    U = int(num_users if num_users is not None else users.max() + 1)
    I = int(num_items if num_items is not None else items.max() + 1)
    rank = p.rank
    rng = np.random.RandomState(p.seed)
    # the JAX package's draws; its float32 training reads them in float32
    uf0 = np.asarray(np.asarray(rng.rand(U, rank).astype(np.float32)
                                / np.sqrt(rank), np.float32), fdt)
    if0 = np.asarray(np.asarray(rng.rand(I, rank).astype(np.float32)
                                / np.sqrt(rank), np.float32), fdt)
    nw = env.num_workers
    nnz = len(ratings)
    L = -(-max(nnz, 1) // nw)
    ids = np.zeros((nw * L, 2), np.int32)          # id-0 padding rows
    rw = np.zeros((nw * L, 2), fdt)                # weight-0 padding rows
    ids[:nnz, 0] = users
    ids[:nnz, 1] = items
    rw[:nnz, 0] = ratings
    rw[:nnz, 1] = 1.0
    # per-worker side-sorted copies + run boundaries (once per training)
    idsU, rwU, idsI, rwI, planU, planI = [], [], [], [], [], []
    for wkr in range(nw):
        ci, cr = ids[wkr * L:(wkr + 1) * L], rw[wkr * L:(wkr + 1) * L]
        si, sr, pl = _sorted_side(ci, cr, 0)
        idsU.append(si)
        rwU.append(sr)
        planU.append(pl)
        si, sr, pl = _sorted_side(ci, cr, 1)
        idsI.append(si)
        rwI.append(sr)
        planI.append(pl)
    Nu = max(pl.shape[0] for pl in planU)
    Ni = max(pl.shape[0] for pl in planI)
    # zero-length (id=0, start=end=0) slots pad to a uniform worker shape
    planU = np.stack([np.concatenate(
        [pl, np.zeros((Nu - pl.shape[0], 3), np.int32)]) for pl in planU])
    planI = np.stack([np.concatenate(
        [pl, np.zeros((Ni - pl.shape[0], 3), np.int32)]) for pl in planI])
    # A is symmetric: only the lower triangle's r(r+1)/2 products ride the
    # prefix pipeline; the full matrix is rebuilt by a gather after the
    # reduction
    il, jl = np.tril_indices(rank)
    unpack = np.zeros((rank, rank), np.int64)
    unpack[il, jl] = np.arange(len(il))
    unpack[jl, il] = np.arange(len(il))
    unpack = unpack.reshape(-1)
    n_tri = len(il)

    def solve_side(ctx, bids, brw, plan, other_col, other_factors, n_rows):
        """Per-id normal equations from this worker's side-sorted rows,
        reduced across workers (the identity at one) and solved: the full
        factor matrix."""
        cpad = contributions(other_factors, bids, brw, other_col,
                             ctx.get_obj("il"), ctx.get_obj("jl"), p)
        intra, inter, mean = prefix_sums(cpad)
        n_pad = -(-n_rows // nw) * nw if p.shard_solve else n_rows
        full = run_slots(intra, inter, mean, plan, n_pad)
        A, b, cnt = full[:, :n_tri], full[:, n_tri:n_tri + rank], full[:, -1]
        if p.shard_solve:
            A = manifest_psum_scatter(A, "d", scatter_dimension=0, tiled=True,
                                      name="als_eq_A", num_workers=nw)
            b = manifest_psum_scatter(b, "d", scatter_dimension=0, tiled=True,
                                      name="als_eq_b", num_workers=nw)
            cnt = manifest_psum_scatter(cnt, "d", scatter_dimension=0,
                                        tiled=True, name="als_eq_cnt",
                                        num_workers=nw)
        else:
            A = manifest_psum(A, "d", name="als_eq_A", num_workers=nw)
            b = manifest_psum(b, "d", name="als_eq_b", num_workers=nw)
            cnt = manifest_psum(cnt, "d", name="als_eq_cnt", num_workers=nw)
        sol = solve_normal(A, b, cnt, ctx.get_obj("unpack"),
                           ctx.get_obj("eye"), p)
        if p.shard_solve:
            sol = manifest_all_gather(sol, "d", axis=0, tiled=True,
                                      name="als_factors",
                                      num_workers=nw)[:n_rows]
        return sol

    def step(ctx):
        if ctx.is_init_step:
            uf0_ = ctx.get_obj("uf0")
            check_full_float32({"X": uf0_})
            ctx.put_obj("uf", uf0_)
            ctx.put_obj("if_", ctx.get_obj("if0"))
            ctx.put_obj("rmse_curve", torch.zeros(
                (p.num_iter,), dtype=torch.float32, device=ctx.device))
            ctx.put_obj("prev_rmse", torch.full(
                (), torch.inf, dtype=torch.float32, device=ctx.device))
            ctx.put_obj("rmse_delta", torch.full(
                (), torch.inf, dtype=torch.float32, device=ctx.device))
        bidsU = ctx.get_obj("idsU")
        brwU = ctx.get_obj("rwU")
        # ---- the two half-sweeps of one superstep ----
        uf = solve_side(ctx, bidsU, brwU, ctx.get_obj("planU"), 1,
                        ctx.get_obj("if_"), U)
        if_ = solve_side(ctx, ctx.get_obj("idsI"), ctx.get_obj("rwI"),
                         ctx.get_obj("planI"), 0, uf, I)
        ctx.put_obj("uf", uf)
        ctx.put_obj("if_", if_)
        # rmse for the curve + stop criterion (user-sorted copy; order is
        # irrelevant for a sum)
        rmse = train_rmse(uf, if_, bidsU, brwU)
        ctx.get_obj("rmse_curve")[ctx.step_no - 1] = rmse
        ctx.put_obj("rmse_delta", torch.abs(ctx.get_obj("prev_rmse") - rmse))
        ctx.put_obj("prev_rmse", rmse)

    queue = (IterativeComQueue(env=env, max_iter=p.num_iter, seed=p.seed)
             .init_with_partitioned_data("idsU", np.concatenate(idsU))
             .init_with_partitioned_data("rwU", np.concatenate(rwU))
             .init_with_partitioned_data("idsI", np.concatenate(idsI))
             .init_with_partitioned_data("rwI", np.concatenate(rwI))
             .init_with_partitioned_data("planU", planU.reshape(-1, 3))
             .init_with_partitioned_data("planI", planI.reshape(-1, 3))
             .init_with_broadcast_data("uf0", uf0)
             .init_with_broadcast_data("if0", if0)
             .init_with_broadcast_data("il", il.astype(np.int64))
             .init_with_broadcast_data("jl", jl.astype(np.int64))
             .init_with_broadcast_data("unpack", unpack)
             .init_with_broadcast_data("eye", np.eye(rank, dtype=fdt))
             .add(step))
    queue.set_program_key(("als", U, I, freeze_config(p), str(dtype)))
    if p.tol > 0:
        # KMeansIterTermination analogue: stop when the train-RMSE moves
        # less than tol between supersteps, after a burn-in of
        # min(4, num_iter) supersteps (ALS from random factors often has a
        # near-flat RMSE plateau on its first iterations); the burn-in
        # supersteps read nothing back
        queue.set_compare_criterion(
            lambda ctx: ctx.step_no >= min(4, p.num_iter)
            and bool(ctx.get_obj("rmse_delta") < p.tol))
    res = queue.exec()
    uf = res.get("uf")
    if_ = res.get("if_")
    curve = np.asarray(res.get("rmse_curve"))[:res.step_count]
    return uf, if_, curve
