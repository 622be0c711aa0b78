"""Optimizers on the one-worker BSP engine.

Counterpart: ``alink_tpu/operator/common/optim/optimizers.py`` (the
reference's Lbfgs.java, Owlqn.java, Gd.java, Sgd.java, Newton.java).
Each optimizer is an ``IterativeComQueue`` program with the JAX
package's stages; the quasi-Newton ones:

  CalcGradient      -> the shard's gradient, loss and weight sums
  AllReduce(glw)    -> the identity at one worker
  CalDirection      -> L-BFGS two-loop over a ring of m = 10 pairs
  CalcLosses        -> the losses at a ladder of 11 step sizes at once
  AllReduce(losses) -> the identity at one worker
  UpdateModel       -> the first argmin step, the coefficient update, the
                       loss curve and the ladder's scale

The JAX package traces the loop into one program. The port runs it
eagerly: ``step_no`` is a Python int, so the ring's position and fill
count are Python ints, and everything that depends on the data
(validity of a pair, gamma, the best step, the ladder's scale, the
convergence bit) stays on the device, masked with ``torch.where``. The
compare criterion's read of the convergence bit is the one host read of
a superstep. The health probes (loss, grad_norm, nonfinite.grad,
update_ratio) are recorded every superstep, as the JAX package records
them by default.

Each optimizer's superstep bodies (``qn_gradient``, ``qn_direction``,
``qn_update``; ``sgd_gradient``, ``sgd_update``; ``newton_hessian``,
``newton_update``) read and write a mapping: the serial stages hand
them the carry (``_CtxState``), ``tuning/sweep.py`` one point's own
state, so a swept point runs its serial fit's ops in their order.

A sparse shard's plan (``objfunc.design_plan``: flat keys, values and the
ordered gradient's run plan) is built once a run, on its entry superstep
(the init pass, or the first superstep after a resume), and kept out of
the carry (``ComContext.put_derived``): a snapshot does not hold it. The
JAX package's one-hot precompute (``fb_onehot_parts``) is a TPU layout
and is not ported.

SGD draws its mini-batch mask a superstep with ``torch.bernoulli`` from
the superstep's generator (``ComContext.rng``), whose draws differ from
JAX's PRNG by design: at ``mini_batch_fraction`` 1.0 the mask is all
ones and the run is the JAX package's; below it, it agrees in its
properties only. NEWTON forms the dense Hessian (``hessian_shard``) and
solves with ``torch.linalg.solve``.

Ported: ``OptimParams``, :func:`optimize` with LBFGS, OWLQN, GD, SGD
and NEWTON, each with superstep checkpoints and resume
(``checkpoint_dir`` / ``checkpoint_every`` / ``checkpoint_keep`` /
``resume_from``, ``engine/recovery.py``): a run killed between
snapshots and resumed from the newest one ends with the uninterrupted
run's coefficients, loss curve and step count, bit for bit.
``OptimParams.health`` attaches a ``common/health.py::HealthMonitor``
through ``IterativeComQueue.set_health``, as in the JAX package: it
reads the probe series after the run and at every snapshot boundary,
and changes no bit of the model.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ....common.mlenv import MLEnvironment
from ....engine import AllReduce, IterativeComQueue
from ....engine.comqueue import freeze_config
from .objfunc import DESIGN, OptimObjFunc, check_full_float32, design_plan

_TINY = 1e-12
_NUM_SEARCH_STEP = 10  # line-search ladder size (reference numSearchStep=4, widened)
_HISTORY = 10          # L-BFGS memory (reference m=10, Lbfgs.java)
_DTYPES = {np.dtype(np.float32): torch.float32,
           np.dtype(np.float64): torch.float64}


@dataclass
class OptimParams:
    method: str = "LBFGS"
    max_iter: int = 100
    epsilon: float = 1e-6
    learning_rate: float = 1.0
    mini_batch_fraction: float = 0.1
    seed: int = 0
    # superstep durability (engine/recovery.py): persist the carry every N
    # supersteps; resume_from= re-enters a killed run with bitwise-
    # identical results
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 1
    checkpoint_keep: int = 3
    resume_from: Optional[str] = None
    # training-health watchdog (common/health.py): a HealthMonitor fed
    # the run's probe series (loss, grad_norm, update_ratio,
    # nonfinite.grad, recorded whenever ALINK_TPU_HEALTH is on) after the
    # run and, on checkpointed runs, at every snapshot boundary; the
    # monitor only reads them
    health: Optional[object] = None


def _apply_checkpoint(queue, params: OptimParams):
    if params.checkpoint_dir:
        # knob validation (every/keep_last >= 1) lives in CheckpointConfig
        queue.set_checkpoint(params.checkpoint_dir,
                             every=int(params.checkpoint_every),
                             keep_last=int(params.checkpoint_keep),
                             resume_from=params.resume_from)
    elif params.resume_from:
        raise ValueError("OptimParams.resume_from requires checkpoint_dir "
                         "(an explicit resume request must not silently "
                         "retrain from scratch)")
    if params.health is not None:
        from ....common.health import warn_if_disabled
        warn_if_disabled("OptimParams.health", stacklevel=4)
        queue.set_health(params.health)
    return queue


def optimize(obj: OptimObjFunc, data: Dict, params: OptimParams,
             env: Optional[MLEnvironment] = None,
             warm_start: Optional[np.ndarray] = None
             ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Run the selected optimizer; returns (coef, loss_curve, num_steps).

    ``data``: host arrays or tensors — dense {"X", "y", "w"}, padded-COO
    {"idx", "val", "y", "w"} or field-blocked {"fb_idx"[, "fb_val"], "y",
    "w"}; they move to the session's device once. The ship dtype is
    ``y``'s (float32 or float64; anything else trains in float32)."""
    method = (params.method or "LBFGS").upper()
    if method == "LBFGS":
        return _quasi_newton(obj, data, params, env, warm_start, owlqn=False)
    if method == "OWLQN":
        return _quasi_newton(obj, data, params, env, warm_start, owlqn=True)
    if method == "GD":
        return _quasi_newton(obj, data, params, env, warm_start, owlqn=False,
                             history=0)
    if method == "SGD":
        return _sgd(obj, data, params, env, warm_start)
    if method == "NEWTON":
        return _newton(obj, data, params, env, warm_start)
    raise ValueError(f"unknown optim method {params.method}")


# ---------------------------------------------------------------------------
# L-BFGS / OWLQN / GD (shared skeleton; GD is history=0)
# ---------------------------------------------------------------------------

def _two_loop(g, sk, yk, pos: int, nvalid: int, m: int):
    """L-BFGS two-loop recursion over the ring (reference Lbfgs.java:109-176
    ``CalDirection``). Pair t (newest first) takes part when ``t <
    nvalid`` (a host int) and its ``s.y > 1e-12`` (on the device). An
    unfilled pair is all zeros and would add exact zeros: the loop skips
    it, keeping the reference's ``r + 0`` of the second loop."""
    if m == 0:
        return g
    q = g
    pairs = []
    for t in range(nvalid):
        j = (pos - 1 - t) % m
        s, yv = sk[j], yk[j]
        sy = torch.dot(s, yv)
        ok = sy > _TINY
        rho = 1.0 / torch.where(ok, sy, 1.0)
        a = torch.where(ok, rho * torch.dot(s, q), 0.0)
        q = q - a * yv
        pairs.append((a, ok, rho, sy, s, yv))
    r = q
    if nvalid > 0:
        sy_l = pairs[0][3]
        yk_l = pairs[0][5]
        yy_l = torch.dot(yk_l, yk_l)
        ok = (sy_l > _TINY) & (yy_l > _TINY)
        gamma = torch.where(ok, sy_l / torch.where(yy_l > _TINY, yy_l, 1.0),
                            1.0)
        r = gamma * q
    for _ in range(m - nvalid):
        r = r + 0.0
    for a, ok, rho, _, s, yv in reversed(pairs):
        b = rho * torch.dot(yv, r)
        r = r + torch.where(ok, (a - b) * s, 0.0)
    return r


def _pseudo_grad(g_plain, coef, l1, reg_mask):
    """OWLQN pseudo-gradient (reference Owlqn.java)."""
    l1m = l1 * reg_mask
    at_zero = torch.where(g_plain + l1m < 0, g_plain + l1m,
                          torch.where(g_plain - l1m > 0, g_plain - l1m, 0.0))
    return torch.where(coef != 0, g_plain + l1m * torch.sign(coef), at_zero)


def _argmin_first(x):
    """``jnp.argmin``: the first index of the minimum, the first NaN when
    there is one."""
    lo = x.min()
    hit = (x == lo) | (torch.isnan(x) & torch.isnan(lo))
    return hit.to(torch.uint8).argmax()


def _ship_dtype(y) -> torch.dtype:
    if isinstance(y, torch.Tensor):
        return y.dtype if y.dtype in (torch.float32, torch.float64) \
            else torch.float32
    return _DTYPES.get(np.asarray(y).dtype, torch.float32)


class _CtxState:
    """A superstep's carry as the mapping the step bodies below read and
    write (``ComContext.get_obj`` / ``put_obj``). The tuning sweep hands
    the same bodies one point's state as a plain dict instead, so a
    swept point runs its serial superstep's ops in their order."""

    def __init__(self, ctx):
        self._ctx = ctx

    def __getitem__(self, name):
        return self._ctx.get_obj(name)

    def __setitem__(self, name, value):
        self._ctx.put_obj(name, value)

    def get(self, name, default=None):
        return self._ctx.get_obj(name) if self._ctx.contains_obj(name) \
            else default


def qn_ladder(learning_rate: float, np_dtype) -> np.ndarray:
    """The line search's step sizes before their scale: 0, then
    ``learning_rate`` times 2, 1, 1/2, ..., 2^-8, in the ship dtype."""
    ladder = learning_rate * np.power(
        2.0, 1 - np.arange(_NUM_SEARCH_STEP, dtype=np.float64))
    return np.concatenate([[0.0], ladder]).astype(np_dtype)


def qn_gradient(obj, shard, st, dtype) -> None:
    """CalcGradient: the shard's gradient, loss and weight sums at
    ``st["coef"]`` into ``st["glw"]``; the margins, where the objective
    gives them, into ``st["eta0"]`` for the line search (same coef)."""
    g, loss, wsum, eta = obj.calc_grad_eta_shard(shard, st["coef"])
    if eta is not None:
        st["eta0"] = eta
    st["glw"] = torch.cat([g.to(dtype), torch.stack([loss, wsum]).to(dtype)])


def qn_direction(obj, shard, st, step: int, m: int, owlqn: bool,
                 eps: float):
    """CalDirection and CalcLosses: the regularized gradient and loss,
    the convergence bit, the ring's new pair (none on superstep 1), the
    two-loop direction and the losses at the ladder of steps. Returns
    ``(loss, grad_norm, gradient)`` for the loss curve and probes."""
    dim = obj.dim
    glw = st["glw"]
    coef = st["coef"]
    W = torch.clamp(glw[dim + 1], min=_TINY)
    g_plain = glw[:dim] / W + obj.l2_grad(coef)
    loss_total = glw[dim] / W + obj.regular_loss(coef)
    if owlqn:
        g_dir = _pseudo_grad(g_plain, coef, obj.l1, obj._reg_mask(coef))
    else:
        g_dir = g_plain
    gnorm = torch.linalg.vector_norm(g_dir) / torch.clamp(
        torch.linalg.vector_norm(coef), min=1.0)
    st["conv"] = gnorm < eps
    if m > 0:
        # push pair (coef - coef_prev, g - g_prev); none on step 1
        pos, nvalid = st["pos"], st["nvalid"]
        sk, yk = st["sk"], st["yk"]
        if step > 1:
            torch.sub(coef, st["coef_prev"], out=sk[pos])
            torch.sub(g_plain, st["grad_prev"], out=yk[pos])
            pos, nvalid = (pos + 1) % m, min(nvalid + 1, m)
            st["pos"] = pos
            st["nvalid"] = nvalid
        d = _two_loop(g_dir, sk, yk, pos, nvalid, m)
    else:
        d = g_dir
    if owlqn:
        d = torch.where(d * g_dir > 0, d, 0.0)
    st["dir"] = d
    st["grad_prev"] = g_plain
    st["pg"] = g_dir
    steps = st["ladder"] * st["step_scale"]
    st["line_losses"] = obj.line_losses_shard(shard, coef, d, steps,
                                              eta0=st.get("eta0"))
    st["steps"] = steps
    return loss_total, gnorm, g_plain


def qn_update(obj, st, owlqn: bool):
    """UpdateModel: the first argmin step of the ladder, the coefficient
    update (OWLQN's orthant projection) and the ladder's scale. Returns
    ``(new coef, old coef)``."""
    dim = obj.dim
    coef = st["coef"]
    d = st["dir"]
    steps = st["steps"]
    W = torch.clamp(st["glw"][dim + 1], min=_TINY)
    reg = obj.regular_loss(coef[None, :] - steps[:, None] * d[None, :])
    total = st["line_losses"] / W + reg
    best = _argmin_first(total)
    s_best = steps.index_select(0, best.reshape(1)).squeeze(0)
    new_coef = coef - s_best * d
    if owlqn:
        pg = st["pg"]
        orthant = torch.where(coef != 0, torch.sign(coef), -torch.sign(pg))
        new_coef = torch.where(new_coef * orthant < 0, 0.0, new_coef)
    st["coef_prev"] = coef
    st["coef"] = new_coef
    # adapt the ladder like the reference's step grow/shrink heuristic
    scale = st["step_scale"]
    scale = torch.where(best == 0, scale * 0.25,
                        torch.where(best == 1, scale * 2.0,
                                    torch.where(best == _NUM_SEARCH_STEP,
                                                scale * 0.5, scale)))
    st["step_scale"] = torch.clamp(scale, 1e-10, 1e6)
    return new_coef, coef


def _quasi_newton(obj, data, params, env, warm_start, owlqn: bool,
                  history: int = _HISTORY):
    dim = obj.dim
    data_keys = tuple(data)
    dtype = _ship_dtype(data["y"])
    m = history
    max_iter = params.max_iter
    eps = params.epsilon
    w0 = _start(dim, dtype, warm_start)
    ladder = qn_ladder(params.learning_rate, w0.dtype)

    def calc_grad(ctx):
        if ctx.is_init_step:
            coef0 = _init_state(ctx, dtype, max_iter)
            dev = coef0.device
            ctx.put_obj("coef_prev", coef0)
            ctx.put_obj("grad_prev", torch.zeros(dim, dtype=dtype, device=dev))
            if m > 0:
                ctx.put_obj("sk", torch.zeros((m, dim), dtype=dtype, device=dev))
                ctx.put_obj("yk", torch.zeros((m, dim), dtype=dtype, device=dev))
            ctx.put_obj("pos", 0)
            ctx.put_obj("nvalid", 0)
            ctx.put_obj("step_scale", torch.ones((), dtype=dtype, device=dev))
            ctx.put_obj("ladder", torch.from_numpy(ladder).to(dev))
        _enter(ctx, obj, data_keys)
        qn_gradient(obj, _shard_views(ctx, data_keys), _CtxState(ctx), dtype)

    def direction_and_losses(ctx):
        loss_total, gnorm, g_plain = qn_direction(
            obj, _shard_views(ctx, data_keys), _CtxState(ctx), ctx.step_no,
            m, owlqn, eps)
        _record_loss(ctx, loss_total, gnorm, g_plain)

    def update_model(ctx):
        new_coef, coef = qn_update(obj, _CtxState(ctx), owlqn)
        _probe_update(ctx, new_coef - coef, coef)

    queue = (IterativeComQueue(env=env, max_iter=max_iter, seed=params.seed)
             .init_with_broadcast_data("coef0", w0)
             .add(calc_grad)
             .add(AllReduce("glw"))
             .add(direction_and_losses)
             .add(AllReduce("line_losses"))
             .add(update_model)
             .set_compare_criterion(lambda ctx: ctx.get_obj("conv"))
             .set_program_key(("qn", owlqn, m, params.learning_rate,
                               params.epsilon, str(dtype), data_keys,
                               freeze_config(obj))))
    return _run(queue, data, params)


# ---------------------------------------------------------------------------
# mini-batch SGD (reference Sgd.java CalcSubGradient :101-140)
# ---------------------------------------------------------------------------

def sgd_gradient(obj, shard, st, frac: float, gen, dtype) -> None:
    """CalcSubGradient: a Bernoulli(``frac``) mask of the rows drawn from
    ``gen`` (the superstep's ``ComContext.rng()``) on the device, and the
    masked shard's gradient, loss and weight sums into ``st["glw"]``."""
    w = shard["w"]
    mask = torch.bernoulli(torch.full(shard["y"].shape, frac, dtype=w.dtype,
                                      device=w.device), generator=gen)
    sub = dict(shard)
    sub["w"] = w * mask
    g, loss, wsum = obj.calc_grad_shard(sub, st["coef"])
    st["glw"] = torch.cat([g.to(dtype), torch.stack([loss, wsum]).to(dtype)])


def sgd_update(obj, st, step: int, learning_rate: float, eps: float,
               dtype):
    """The step ``learning_rate / sqrt(step)`` along the mean gradient,
    the L1 soft-threshold, an empty mini-batch's skip and the
    convergence bit. Returns ``(loss, gradient, new coef, old coef)``."""
    dim = obj.dim
    glw = st["glw"]
    coef = st["coef"]
    wsum = glw[dim + 1]
    nonempty = wsum > 0
    W = torch.clamp(wsum, min=_TINY)
    g = glw[:dim] / W + obj.l2_grad(coef)
    lr = learning_rate / torch.sqrt(
        torch.tensor(float(step), dtype=dtype, device=coef.device))
    new_coef = coef - lr * g
    if obj.l1 > 0:  # proximal soft-threshold for L1
        thr = obj.l1 * lr * obj._reg_mask(coef)
        new_coef = torch.sign(new_coef) * torch.clamp(
            torch.abs(new_coef) - thr, min=0.0)
    new_coef = torch.where(nonempty, new_coef, coef)  # skip empty batches
    st["coef"] = new_coef
    loss_total = glw[dim] / W + obj.regular_loss(coef)
    st["conv"] = nonempty & (
        torch.linalg.vector_norm(lr * g) < eps * torch.clamp(
            torch.linalg.vector_norm(coef), min=1.0))
    return loss_total, g, new_coef, coef


def _sgd(obj, data, params, env, warm_start):
    dim = obj.dim
    data_keys = tuple(data)
    dtype = _ship_dtype(data["y"])
    max_iter = params.max_iter
    frac = params.mini_batch_fraction
    w0 = _start(dim, dtype, warm_start)

    def calc_grad(ctx):
        if ctx.is_init_step:
            _init_state(ctx, dtype, max_iter)
        _enter(ctx, obj, data_keys)
        # this superstep's random sub-sample, drawn on the device
        sgd_gradient(obj, _shard_views(ctx, data_keys), _CtxState(ctx), frac,
                     ctx.rng(), dtype)

    def update(ctx):
        loss_total, g, new_coef, coef = sgd_update(
            obj, _CtxState(ctx), ctx.step_no, params.learning_rate,
            params.epsilon, dtype)
        _record_loss(ctx, loss_total, torch.linalg.vector_norm(g), g)
        _probe_update(ctx, new_coef - coef, coef)

    queue = (IterativeComQueue(env=env, max_iter=max_iter, seed=params.seed)
             .init_with_broadcast_data("coef0", w0)
             .add(calc_grad)
             .add(AllReduce("glw"))
             .add(update)
             .set_compare_criterion(lambda ctx: ctx.get_obj("conv"))
             .set_program_key(("sgd", params.learning_rate, params.epsilon,
                               params.mini_batch_fraction, str(dtype),
                               data_keys, freeze_config(obj))))
    return _run(queue, data, params)


# ---------------------------------------------------------------------------
# Newton (reference Newton.java: dense Hessian + solve)
# ---------------------------------------------------------------------------

def newton_hessian(obj, shard, st, dtype) -> None:
    """The shard's Hessian sum into ``st["H"]``, its gradient, loss and
    weight sums into ``st["glw"]``."""
    H, g, loss, wsum = obj.hessian_shard(shard, st["coef"])
    st["H"] = H
    st["glw"] = torch.cat([g.to(dtype), torch.stack([loss, wsum]).to(dtype)])


def newton_update(obj, st, eps: float):
    """The Newton step (the ridge and a 1e-8 diagonal on the mean
    Hessian, ``torch.linalg.solve``) and the convergence bit. Returns
    ``(loss, gradient, step, old coef)``."""
    dim = obj.dim
    glw = st["glw"]
    coef = st["coef"]
    W = torch.clamp(glw[dim + 1], min=_TINY)
    g = glw[:dim] / W + obj.l2_grad(coef)
    H = st["H"] / W
    reg_diag = obj.l2 * obj._reg_mask(coef) + 1e-8
    H = H + torch.diag(reg_diag.to(H.dtype))
    d = torch.linalg.solve(H, g)
    st["coef"] = coef - d
    loss_total = glw[dim] / W + obj.regular_loss(coef)
    st["conv"] = torch.linalg.vector_norm(d) < eps * torch.clamp(
        torch.linalg.vector_norm(coef), min=1.0)
    return loss_total, g, d, coef


def _newton(obj, data, params, env, warm_start):
    dim = obj.dim
    data_keys = tuple(data)
    dtype = _ship_dtype(data["y"])
    max_iter = params.max_iter
    w0 = _start(dim, dtype, warm_start)

    def calc(ctx):
        if ctx.is_init_step:
            _init_state(ctx, dtype, max_iter)
        _enter(ctx, obj, data_keys, densified=True)
        newton_hessian(obj, _shard_views(ctx, data_keys), _CtxState(ctx),
                       dtype)

    def update(ctx):
        loss_total, g, d, coef = newton_update(obj, _CtxState(ctx),
                                               params.epsilon)
        _record_loss(ctx, loss_total, torch.linalg.vector_norm(g), g)
        _probe_update(ctx, d, coef)

    queue = (IterativeComQueue(env=env, max_iter=max_iter, seed=params.seed)
             .init_with_broadcast_data("coef0", w0)
             .add(calc)
             .add(AllReduce("H"))
             .add(AllReduce("glw"))
             .add(update)
             .set_compare_criterion(lambda ctx: ctx.get_obj("conv"))
             .set_program_key(("newton", params.epsilon, str(dtype),
                               data_keys, freeze_config(obj))))
    return _run(queue, data, params)


# ---------------------------------------------------------------------------

def _start(dim: int, dtype: torch.dtype, warm_start) -> np.ndarray:
    """The starting coefficients on the host: zeros, or the warm start."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    return np.zeros(dim, np_dtype) if warm_start is None \
        else np.asarray(warm_start, np_dtype)


def _init_state(ctx, dtype, max_iter: int):
    """The state every optimizer keeps, built in the init superstep:
    ``coef`` from ``coef0``, the NaN loss curve and the convergence bit.
    Returns ``coef0``. The data-derived rest is :func:`_enter`'s."""
    coef0 = ctx.get_obj("coef0")
    ctx.put_obj("coef", coef0)
    ctx.put_obj("loss_curve", torch.full((max_iter,), float("nan"),
                                         dtype=dtype, device=coef0.device))
    ctx.put_obj("conv", torch.zeros((), dtype=torch.bool,
                                    device=coef0.device))
    return coef0


def _enter(ctx, obj, keys, densified: bool = False) -> None:
    """On a run's entry superstep (the init pass, or the first superstep
    after a resume): the TF32 check of the training's dense products
    (``densified``: Newton's Hessian reads the densified design) and the
    design's plan, built once and kept out of the carry (a sparse shard
    only)."""
    if not ctx.is_entry_step:
        return
    shard = _shard_views(ctx, keys)
    check_full_float32(shard, densified)
    plan = design_plan(shard, obj.design_dim, getattr(obj, "fb_meta", None))
    if plan is not None:
        ctx.put_derived(DESIGN, plan)


def _record_loss(ctx, loss, grad_norm, grad) -> None:
    """This superstep's loss into the curve, and the loss, grad_norm and
    nonfinite.grad probes."""
    ctx.get_obj("loss_curve")[ctx.step_no - 1] = loss
    ctx.probe("loss", loss)
    ctx.probe("grad_norm", grad_norm)
    ctx.probe_nonfinite("grad", grad)


def _probe_update(ctx, step, coef) -> None:
    """The update_ratio probe: |step| over max(|coef|, 1)."""
    if not ctx.probes_enabled:
        return      # no norms queued for a probe that records nothing
    ctx.probe("update_ratio", torch.linalg.vector_norm(step)
              / torch.clamp(torch.linalg.vector_norm(coef), min=1.0))


def _run(queue, data, params: OptimParams):
    """Partition the training arrays into the queue, set its checkpoint,
    run it; (coef, loss curve, supersteps)."""
    for k, v in data.items():
        queue.init_with_partitioned_data(k, v)
    _apply_checkpoint(queue, params)
    res = queue.exec()
    steps = res.step_count
    return res.get("coef"), _trim_curve(res.get("loss_curve"), steps), steps


def _shard_views(ctx, keys):
    """This worker's shards of the partitioned training arrays, and the
    design's plan once the init superstep has built it."""
    out = {k: ctx.get_obj(k) for k in keys}
    if ctx.contains_obj(DESIGN):
        out[DESIGN] = ctx.get_obj(DESIGN)
    return out


def _trim_curve(curve: np.ndarray, steps: int) -> np.ndarray:
    """The executed prefix of the preallocated loss history, trimmed by the
    engine's superstep count (never by counting non-NaN entries: a NaN
    loss mid-run would mis-index the curve against the probe series)."""
    curve = np.asarray(curve)
    return curve[:int(steps)]
