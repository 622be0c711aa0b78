"""The sweep executor — N hyperparameter points through one queue a group.

Counterpart: ``alink_tpu/tuning/sweep.py``. The contract is the JAX
package's: each swept point's result is **bitwise its serial fit**.
There the per-point kernels mirror the serial stages op for op under a
fixed-order ``lax.map``; here there is no second copy to drift: the
serial optimizers' superstep bodies (``optimizers.py::qn_gradient``,
``qn_direction``, ``qn_update``, ``sgd_*``, ``newton_*``) and the Lloyd
halves (``kmeans.py::lloyd_buffer``, ``lloyd_update``) are called for
each point in turn, on that point's own tensors, with that point's
objective (a copy of the base one with its l1 and l2). Same ops, same
order, same shapes and the same allocations as the serial run, so the
same bits, on the CPU and on the card (each point's state is its own
tensor, as the serial run's is, never a view into a stacked one: a
CUDA reduction's order depends on its input's alignment).

Execution shape:

* a compile group (``SweepPlan.groups()``: points that share their
  trace-shaping values) is one ``IterativeComQueue`` with one stage;
  ``programs`` counts the groups. The carry holds the population under
  the JAX package's names: ``pt_coef``, ``pt_coef_prev``,
  ``pt_grad_prev``, ``pt_step_scale``, ``pt_sk``, ``pt_yk`` (lists of a
  tensor a point), ``pt_pos``, ``pt_nvalid`` (the L-BFGS ring's host
  counters), ``pt_loss_curve`` (P, max_iter), ``pt_conv``,
  ``pt_cur_loss``, ``sw_alive`` (P,) lanes on the device, ``sw_steps``
  and the rung log ``sw_rungs`` on the host. A checkpoint therefore
  holds the whole population and its pruning decisions;
* each superstep reads the (P,) active lane once, then walks the points
  in fixed order; a pruned or converged point skips its step and keeps
  its carry untouched (the JAX package's ``_freeze_cond``). The design's
  run plan is built once a group, on its entry superstep, and every
  point walks it;
* ASHA successive halving runs at the engine's boundaries
  (``IterativeComQueue.set_boundary``): one host copy of the alive,
  conv and loss lanes, keep the top ``ceil(alive / eta)`` by (loss,
  point index), non-finite losses last, never fewer than
  ``min_points``. A decision is a function of the carry alone, so a
  killed and resumed sweep re-derives it bitwise.

``sweep_ftrl`` runs the bounded-staleness FTRL step
(``ftrl.py::ftrl_staleness_step``: B1 and B2 once a K-row chunk) for
each point in turn on each micro-batch. The port has one worker, so the
state is not padded (``dim_pad == dim``).

Not ported: the compile ledger and the program-cache key derivation
(``common/plan.py``): eager PyTorch compiles no program, and the group's
key only enters the checkpoint signature (ROADMAP A10(b)). The
field-blocked one-hot precompute is not ported (nor in serial training,
``optimizers.py``). A failure inside a sweep propagates; the tuning
layer does not turn it into a serial run (``pipeline/tuning.py``).
"""

from __future__ import annotations

import copy
import os
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .plan import AshaConfig, SweepPlan

__all__ = ["SweepResult", "FtrlSweepResult", "record_sweep_fallback",
           "sweep_enabled", "sweep_eta", "sweep_rung", "sweep_optimize",
           "sweep_kmeans", "sweep_ftrl"]


# -- flags ------------------------------------------------------------------

def sweep_enabled() -> bool:
    """``ALINK_TPU_SWEEP`` (default off): route GridSearchCV /
    GridSearchTVSplit candidate loops through the sweep engine when
    every grid axis is carry-resident for a supported estimator."""
    from ..common.flags import flag_value
    return bool(flag_value("ALINK_TPU_SWEEP", False))


def sweep_eta() -> int:
    """``ALINK_TPU_SWEEP_ETA``: the default ASHA reduction factor."""
    from ..common.flags import flag_value
    return int(flag_value("ALINK_TPU_SWEEP_ETA", 3))


def sweep_rung() -> int:
    """``ALINK_TPU_SWEEP_RUNG``: default rung period in supersteps for
    sweeps that enable pruning without an explicit AshaConfig
    (0 = ``max(1, max_iter // 4)``)."""
    from ..common.flags import flag_value
    return int(flag_value("ALINK_TPU_SWEEP_RUNG", 0))


# -- fallback observability (common.metrics.record_fallback_once) -----------
# Every time the tuning layer declines the sweep engine it records a
# labelled counter and ONE RuntimeWarning per (estimator, reason).
# ``reason`` is a small enum (a metric label): "unsupported-estimator",
# "trace-shaping-axis" or "unsupported-evaluator"; the text goes in
# ``detail``. The JAX package's fourth reason, ``sweep-error``, is not
# ported: an error inside a sweep propagates.


def record_sweep_fallback(estimator: str, reason: str,
                          detail: str = "") -> None:
    """``alink_sweep_fallback_total{estimator=, reason=}`` + one
    RuntimeWarning per (estimator, reason) pair per process."""
    from ..common.metrics import record_fallback_once
    record_fallback_once(
        "sweep", "alink_sweep_fallback_total",
        {"estimator": estimator, "reason": reason},
        f"tuning sweep falls back to the serial candidate loop for "
        f"{estimator}: {reason}{' (' + detail + ')' if detail else ''} "
        f"(recorded as alink_sweep_fallback_total{{estimator="
        f"{estimator!r},reason={reason!r}}}; this warning fires once "
        f"per estimator+reason)")


def _reset_fallback_warnings() -> None:
    """Test hook: re-arm the once-per-(estimator, reason) warnings."""
    from ..common.metrics import reset_fallback_warnings
    reset_fallback_warnings("sweep")


# -- result -----------------------------------------------------------------

@dataclass
class SweepResult:
    """Per-point outcomes of one sweep (all groups merged).

    ``values`` holds the trainer's model state per point — ``coef``
    ``(P, dim)`` for the optimizers; ``centroids`` ``(P, k, d)`` +
    ``cluster_weights`` ``(P, k)`` for k-means (lists of per-point
    arrays instead when a trace-shaping ``k`` axis makes the geometry
    ragged across compile groups). ``steps[p]`` is the executed
    superstep count of point ``p`` (== the serial fit's step count);
    ``final_loss[p]`` its last computed training loss (weighted inertia
    for k-means, computed whatever ``ALINK_TPU_HEALTH`` says, so rung
    decisions never flip with telemetry); ``alive[p]`` whether ASHA kept
    it; ``rungs`` the boundary decisions in order. ``programs`` counts
    the sweep's queues (== trace-shaping groups)."""
    trainer: str
    points: List[Dict[str, Any]]
    values: Dict[str, np.ndarray]
    steps: np.ndarray
    final_loss: np.ndarray
    alive: np.ndarray
    converged: np.ndarray
    loss_curves: List[np.ndarray]
    rungs: List[Dict[str, Any]] = field(default_factory=list)
    programs: int = 1

    @property
    def num_points(self) -> int:
        return len(self.points)

    @property
    def pruned_at(self) -> Dict[int, int]:
        out: Dict[int, int] = {}
        for r in self.rungs:
            for i in r["pruned"]:
                out.setdefault(int(i), int(r["step"]))
        return out

    def survivors(self) -> List[int]:
        return [int(i) for i in np.flatnonzero(self.alive)]

    @property
    def best(self) -> int:
        """The winning point: lowest final loss among survivors, ties
        broken by lowest point index — deterministic and seed-free."""
        live = np.flatnonzero(self.alive)
        if live.size == 0:          # defensive: never prunes to zero
            live = np.arange(len(self.points))
        key = np.where(np.isfinite(self.final_loss[live]),
                       self.final_loss[live], np.inf)
        order = np.lexsort((live, key))
        return int(live[order[0]])


# -- the group queue ----------------------------------------------------------

def _sweep_criterion(ctx) -> bool:
    """Stop when every still-alive point has converged (one host read),
    or when the rung hook has seen the survivors all converged."""
    if ctx.contains_obj("__stop") and ctx.get_obj("__stop"):
        return True
    return bool((ctx.get_obj("pt_conv") | ~ctx.get_obj("sw_alive")).all())


def _active(ctx, P: int) -> np.ndarray:
    """The points that step this superstep (alive and not converged):
    every point in the init pass, else one host read of the lanes."""
    if ctx.is_init_step:
        return np.ones(P, bool)
    return (ctx.get_obj("sw_alive")
            & ~ctx.get_obj("pt_conv")).cpu().numpy()


def _finish_superstep(ctx, active: np.ndarray) -> None:
    """The executed-step counters and the population probes."""
    ctx.put_obj("sw_steps", ctx.get_obj("sw_steps") + active)
    alive = ctx.get_obj("sw_alive")
    lane = torch.where(alive, ctx.get_obj("pt_cur_loss"), torch.inf)
    ctx.probe("sweep.best_loss", lane.min())
    ctx.probe("sweep.alive", alive.sum())


def _init_lanes(ctx, P: int, max_iter: int, dtype) -> None:
    """The lanes every sweep keeps, built in the init pass."""
    dev = ctx.device
    ctx.put_obj("pt_loss_curve", torch.full((P, max_iter), float("nan"),
                                            dtype=dtype, device=dev))
    ctx.put_obj("pt_conv", torch.zeros(P, dtype=torch.bool, device=dev))
    ctx.put_obj("pt_cur_loss", torch.full((P,), float("inf"), dtype=dtype,
                                          device=dev))
    ctx.put_obj("sw_alive", torch.ones(P, dtype=torch.bool, device=dev))
    ctx.put_obj("sw_steps", np.zeros(P, np.int64))
    ctx.put_obj("sw_rungs", [])


def _make_asha_hook(asha: AshaConfig, num_points: int,
                    persist: bool) -> Callable:
    """The boundary rung: one host copy of the alive, conv and loss
    lanes, keep the deterministic top ``ceil(alive / eta)``, flip the
    alive lane and log the decision in the carry's ``sw_rungs``. It runs
    after the boundary's snapshot is handed over and again after a
    resume, so a resumed sweep re-derives the decision (and its log,
    which the snapshot holds) bitwise.

    Once the population is down to ``min_points`` there is nothing left
    to decide: the hook marks itself ``exhausted``. Without a checkpoint
    directory it then returns at once (the JAX package runs the rest as
    one chunk with no boundary); with one, the snapshot cadence keeps
    the boundaries and the log goes on."""

    def hook(carry, step):
        if hook.exhausted and not persist:
            return None
        lanes = torch.stack([carry["sw_alive"].to(torch.float64),
                             carry["pt_conv"].to(torch.float64),
                             carry["pt_cur_loss"].to(torch.float64)])
        alive_f, conv_f, loss = lanes.cpu().numpy()
        alive, conv = alive_f > 0, conv_f > 0
        live = np.flatnonzero(alive)
        keep_n = max(int(asha.min_points),
                     int(np.ceil(live.size / float(asha.eta))))
        pruned: List[int] = []
        new_alive = alive
        if keep_n < live.size:
            # deterministic, seed-free: rank by (loss, point index),
            # non-finite losses last
            key = np.where(np.isfinite(loss[live]), loss[live], np.inf)
            order = np.lexsort((live, key))
            keep = live[order[:keep_n]]
            new_alive = np.zeros(num_points, bool)
            new_alive[keep] = True
            pruned = sorted(int(i) for i in set(live) - set(keep))
        out = dict(carry)
        out["sw_rungs"] = list(carry["sw_rungs"]) + [
            {"step": int(step), "alive_before": int(live.size),
             "alive_after": int(np.count_nonzero(new_alive)),
             "pruned": pruned}]
        if np.count_nonzero(new_alive) <= int(asha.min_points):
            hook.exhausted = True
        if pruned:
            from ..common.metrics import get_registry, metrics_enabled
            if metrics_enabled():
                get_registry().inc("alink_sweep_pruned_points_total",
                                   len(pruned))
            out["sw_alive"] = torch.from_numpy(new_alive).to(
                carry["sw_alive"].device)
            if np.all(conv | ~new_alive):
                # the surviving population has converged: stop now
                # instead of running one more (frozen) superstep
                out["__stop"] = True
        return out

    hook.exhausted = False
    return hook


def _run_sweep_queue(*, kind: str, stage, parts: Dict[str, Any],
                     bcast: Dict[str, Any], env, max_iter: int, seed: int,
                     key_tail: Tuple, num_points: int,
                     asha: Optional[AshaConfig],
                     checkpoint_dir: Optional[str],
                     checkpoint_keep: int, resume_from: Optional[str]):
    """Build and run the one queue of a compile group. Its program key
    (the sweep kind, the group's geometry and every point's hyperparameter
    values) enters the checkpoint signature only."""
    from ..engine import IterativeComQueue

    queue = IterativeComQueue(env=env, max_iter=int(max_iter),
                              seed=int(seed))
    for k, v in parts.items():
        queue.init_with_partitioned_data(k, v)
    for k, v in bcast.items():
        queue.init_with_broadcast_data(k, v)
    queue.add(stage)
    queue.set_compare_criterion(_sweep_criterion)
    queue.set_program_key(("sweep", kind) + tuple(key_tail))
    if checkpoint_dir:
        queue.set_checkpoint(checkpoint_dir,
                             every=(asha.rung if asha is not None else 1),
                             keep_last=int(checkpoint_keep),
                             resume_from=resume_from)
    elif resume_from:
        raise ValueError("resume_from requires checkpoint_dir (an explicit "
                         "resume request must not silently retrain)")
    if asha is not None:
        queue.set_boundary(asha.rung,
                           _make_asha_hook(asha, num_points,
                                           bool(checkpoint_dir)))
    return queue.exec()


def _group_paths(checkpoint_dir: Optional[str],
                 resume_from: Optional[str], gi: int,
                 n_groups: int) -> Tuple[Optional[str], Optional[str]]:
    """Per-compile-group checkpoint/resume directories: multi-group
    sweeps snapshot each group under its own subdirectory so the
    signatures can never collide."""
    if not checkpoint_dir or n_groups <= 1:
        return checkpoint_dir, resume_from
    return (os.path.join(checkpoint_dir, f"group{gi}"),
            os.path.join(resume_from, f"group{gi}") if resume_from
            else None)


def _resolve_asha(asha, max_iter: int) -> Optional[AshaConfig]:
    """``None``/``False`` = no pruning; ``True`` = flag-driven defaults
    (``ALINK_TPU_SWEEP_ETA`` / ``ALINK_TPU_SWEEP_RUNG``); an
    ``AshaConfig`` passes through."""
    if not asha:
        return None
    if isinstance(asha, AshaConfig):
        return asha
    rung = sweep_rung() or max(1, int(max_iter) // 4)
    return AshaConfig(rung=rung, eta=sweep_eta())


def _collect(res, idxs, out: Dict[str, Any], gi: int,
             host_lists=()) -> None:
    """Scatter a group's final lanes into the population's arrays."""
    steps = np.asarray(res.get("sw_steps"))
    loss = np.asarray(res.get("pt_cur_loss"))
    alive = np.asarray(res.get("sw_alive"))
    conv = np.asarray(res.get("pt_conv"))
    lists = {n: res.get("pt_" + n) for n in host_lists}
    for j, i in enumerate(idxs):
        out["steps"][i] = steps[j]
        out["loss"][i] = loss[j]
        out["alive"][i] = alive[j]
        out["conv"][i] = conv[j]
        for n, vals in lists.items():
            out[n][i] = np.array(vals[j])
    for r in res.get("sw_rungs"):
        out["rungs"].append({**r, "group": gi,
                             "pruned": [int(idxs[p]) for p in r["pruned"]]})


def _population(P_total: int, *names) -> Dict[str, Any]:
    return {"steps": np.zeros(P_total, np.int64),
            "loss": np.full(P_total, np.nan),
            "alive": np.ones(P_total, bool),
            "conv": np.zeros(P_total, bool), "rungs": [],
            **{n: [None] * P_total for n in names}}


# -- optimizer sweeps -------------------------------------------------------

_QN_LISTS = ("coef", "coef_prev", "grad_prev", "step_scale")
_QN_RING = ("sk", "yk")


def _point_objective(obj, l1: float, l2: float):
    """The base objective with one point's regularization: its
    ``l2_grad`` and ``regular_loss`` are the serial ones, unchanged."""
    o = copy.copy(obj)
    o.l1 = float(l1)
    o.l2 = float(l2)
    return o


def _make_optimizer_stage(objs, data_keys: Tuple[str, ...], dim: int,
                          dtype, method: str, m: int, max_iter: int,
                          hyp: List[Dict[str, float]]):
    """One engine stage running P points of one optimizer family: each
    live point's serial superstep on its own state, in point order."""
    from ..operator.common.optim import optimizers as opt

    P = len(objs)
    owlqn = method == "OWLQN"
    sgd = method == "SGD"
    newton = method == "NEWTON"
    qn = not (sgd or newton)
    lists = _QN_LISTS + (_QN_RING if m > 0 else ()) if qn else ("coef",)

    def stage(ctx):
        if ctx.is_init_step:
            _init_lanes(ctx, P, max_iter, dtype)
            dev = ctx.device
            coef0 = ctx.get_obj("swh_coef0")
            ctx.put_obj("pt_coef", list(coef0))
            if qn:
                ctx.put_obj("pt_coef_prev", list(coef0))
                ctx.put_obj("pt_grad_prev", [
                    torch.zeros(dim, dtype=dtype, device=dev)
                    for _ in range(P)])
                ctx.put_obj("pt_step_scale", [
                    torch.ones((), dtype=dtype, device=dev)
                    for _ in range(P)])
                if m > 0:
                    for n in _QN_RING:
                        ctx.put_obj("pt_" + n, [
                            torch.zeros((m, dim), dtype=dtype, device=dev)
                            for _ in range(P)])
                ctx.put_obj("pt_pos", np.zeros(P, np.int64))
                ctx.put_obj("pt_nvalid", np.zeros(P, np.int64))
        opt._enter(ctx, objs[0], data_keys, densified=newton)
        shard = opt._shard_views(ctx, data_keys)
        active = _active(ctx, P)
        step = ctx.step_no
        curve = ctx.get_obj("pt_loss_curve")
        lanes = {n: ctx.get_obj("pt_" + n) for n in lists}
        if qn:
            pos, nvalid = ctx.get_obj("pt_pos"), ctx.get_obj("pt_nvalid")
            ladders = ctx.get_obj("swh_ladder")
        for p in np.flatnonzero(active):
            obj, hp = objs[p], hyp[p]
            st = {n: lanes[n][p] for n in lists}
            if qn:
                st.update(pos=int(pos[p]), nvalid=int(nvalid[p]),
                          ladder=ladders[p])
                opt.qn_gradient(obj, shard, st, dtype)
                loss, _, _ = opt.qn_direction(obj, shard, st, step, m,
                                              owlqn, hp["eps"])
                opt.qn_update(obj, st, owlqn)
                pos[p], nvalid[p] = st["pos"], st["nvalid"]
            elif sgd:
                opt.sgd_gradient(obj, shard, st, hp["frac"], ctx.rng(),
                                 dtype)
                loss = opt.sgd_update(obj, st, step, hp["lr"], hp["eps"],
                                      dtype)[0]
            else:
                opt.newton_hessian(obj, shard, st, dtype)
                loss = opt.newton_update(obj, st, hp["eps"])[0]
            for n in lists:
                lanes[n][p] = st[n]
            curve[p, step - 1] = loss
            ctx.get_obj("pt_cur_loss")[p] = loss
            ctx.get_obj("pt_conv")[p] = st["conv"]
        _finish_superstep(ctx, active)

    stage.__name__ = f"sweep_{method.lower()}"
    return stage


def sweep_optimize(obj, data: Dict[str, Any], params, points:
                   Sequence[Dict[str, Any]], env=None, warm_starts=None,
                   asha=None, checkpoint_dir: Optional[str] = None,
                   checkpoint_keep: int = 3,
                   resume_from: Optional[str] = None) -> SweepResult:
    """Sweep N hyperparameter points of the iterative optimizers
    (LBFGS/OWLQN/GD/SGD/Newton), one queue per compile group.

    ``obj``/``data``/``params``/``env`` are exactly
    :func:`~alink_tpu_torch.operator.common.optim.optimizers.optimize`'s
    inputs (dense, padded-COO or field-blocked data); ``points`` is a
    list of per-point override dicts over the carry-resident axes
    (``learning_rate``, ``epsilon``, ``l1``, ``l2``,
    ``mini_batch_fraction``) and/or trace-shaping axes (``method``,
    ``max_iter``, ``seed`` — each distinct combination is its own
    group). ``warm_starts`` is an optional ``(P, dim)`` stack. ``asha``
    is ``None`` (train every point to completion — the GridSearchCV
    mode), ``True`` (flag-driven schedule) or an
    :class:`~alink_tpu_torch.tuning.plan.AshaConfig`.

    Each point's coefficients, loss curve and step count are bitwise
    ``optimize()``'s with that point's parameters."""
    from ..operator.common.optim.optimizers import (_HISTORY, _ship_dtype,
                                                    qn_ladder)
    from ..engine.comqueue import freeze_config
    base_method = (params.method or "LBFGS").upper()
    plan = SweepPlan("optimizer", [dict(p) for p in points],
                     base={"method": base_method,
                           "max_iter": int(params.max_iter),
                           "seed": int(params.seed)})
    dim = obj.dim
    dtype = _ship_dtype(data["y"])
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    data_keys = tuple(data)
    P_total = plan.num_points
    pop = _population(P_total, "coef")
    curves: List[np.ndarray] = [np.zeros(0, np_dtype)] * P_total
    groups = plan.groups()
    for gi, (tkey, idxs) in enumerate(groups):
        gcfg = dict(tkey)
        method = str(gcfg["method"] or "LBFGS").upper()
        max_iter = int(gcfg["max_iter"])
        if method not in ("LBFGS", "OWLQN", "GD", "SGD", "NEWTON"):
            raise ValueError(f"unknown optim method {method!r}")
        m = {"LBFGS": _HISTORY, "OWLQN": _HISTORY}.get(method, 0)
        pts = [plan.points[i] for i in idxs]
        hyp = [{"lr": float(pt.get("learning_rate", params.learning_rate)),
                "eps": float(pt.get("epsilon", params.epsilon)),
                "l1": float(pt.get("l1", obj.l1)),
                "l2": float(pt.get("l2", obj.l2)),
                "frac": float(pt.get("mini_batch_fraction",
                                     params.mini_batch_fraction))}
               for pt in pts]
        objs = [_point_objective(obj, h["l1"], h["l2"]) for h in hyp]
        # each point's start and ladder is an array of its own, as the
        # serial run's (optimizers.py::_start, qn_ladder)
        c0 = [np.zeros(dim, np_dtype) if warm_starts is None
              else np.array(warm_starts[i], np_dtype) for i in idxs]
        bcast = {"swh_coef0": c0}
        if method not in ("SGD", "NEWTON"):
            bcast["swh_ladder"] = [qn_ladder(h["lr"], np_dtype) for h in hyp]
        stage = _make_optimizer_stage(objs, data_keys, dim, dtype, method, m,
                                      max_iter, hyp)
        ck_dir, rs = _group_paths(checkpoint_dir, resume_from, gi,
                                  len(groups))
        res = _run_sweep_queue(
            kind=f"opt_{method.lower()}", stage=stage, parts=data,
            bcast=bcast, env=env, max_iter=max_iter, seed=int(gcfg["seed"]),
            key_tail=(m, str(dtype), data_keys, freeze_config(obj),
                      tuple(tuple(sorted(h.items())) for h in hyp)),
            num_points=len(idxs), asha=_resolve_asha(asha, max_iter),
            checkpoint_dir=ck_dir, checkpoint_keep=checkpoint_keep,
            resume_from=rs)
        _collect(res, idxs, pop, gi, host_lists=("coef",))
        g_curves = np.asarray(res.get("pt_loss_curve"))
        for j, i in enumerate(idxs):
            curves[i] = np.array(g_curves[j][:int(pop["steps"][i])])
    return SweepResult(trainer="optimizer", points=plan.points,
                       values={"coef": np.stack(pop["coef"])},
                       steps=pop["steps"], final_loss=pop["loss"],
                       alive=pop["alive"], converged=pop["conv"],
                       loss_curves=curves, rungs=pop["rungs"],
                       programs=len(groups))


# -- k-means sweep ----------------------------------------------------------

def _make_kmeans_stage(P: int, k: int, distance_type: str, max_iter: int,
                       dtype, tols: List[float]):
    """``kmeans_train``'s Lloyd superstep for P points, each with its own
    centroids and tolerance. The inertia row always rides the buffer
    (the loss lane ASHA ranks by): it is one more row of the buffer, so
    the centroids are those of the serial run with the probes on or
    off."""
    from ..operator.common.clustering.kmeans import (lloyd_buffer,
                                                     lloyd_update)
    from ..operator.common.optim.objfunc import check_full_float32

    def stage(ctx):
        if ctx.is_entry_step:
            check_full_float32({"X": ctx.get_obj("data")})
        if ctx.is_init_step:
            _init_lanes(ctx, P, max_iter, dtype)
            ctx.put_obj("pt_centroids", list(ctx.get_obj("swh_init_centroids")))
            ctx.put_obj("pt_cluster_weights", [
                torch.zeros(k, dtype=dtype, device=ctx.device)
                for _ in range(P)])
            ctx.put_obj("pt_movement", torch.full((P,), float("inf"),
                                                  dtype=dtype,
                                                  device=ctx.device))
        block = ctx.get_obj("data")
        active = _active(ctx, P)
        cents = ctx.get_obj("pt_centroids")
        weights = ctx.get_obj("pt_cluster_weights")
        for p in np.flatnonzero(active):
            C = cents[p]
            buf = lloyd_buffer(block, C, k, distance_type, True)
            cur = buf[k, 0]
            newC, movement, cnts = lloyd_update(buf, C, k)
            cents[p], weights[p] = newC, cnts
            ctx.get_obj("pt_movement")[p] = movement
            ctx.get_obj("pt_conv")[p] = movement < tols[p]
            ctx.get_obj("pt_cur_loss")[p] = cur
            ctx.get_obj("pt_loss_curve")[p, ctx.step_no - 1] = cur
        _finish_superstep(ctx, active)

    stage.__name__ = "sweep_kmeans"
    return stage


def sweep_kmeans(X: np.ndarray, k: int, points: Sequence[Dict[str, Any]],
                 max_iter: int = 50, tol: float = 1e-4,
                 distance_type: str = "EUCLIDEAN",
                 init: str = "K_MEANS_PARALLEL", seed: int = 0, env=None,
                 sample_weight: Optional[np.ndarray] = None, asha=None,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_keep: int = 3,
                 resume_from: Optional[str] = None) -> SweepResult:
    """Sweep N ``kmeans_train`` points, one queue per compile group.
    Carry-resident axes: ``tol`` and the init ``seed`` (the init
    centroids are host data, so a seed grid shares one group);
    trace-shaping axes: ``k``, ``distance_type``, ``init``,
    ``max_iter``. Each point's centroids, weights and step count are
    bitwise ``kmeans_train``'s with that point's parameters."""
    from ..operator.common.clustering.kmeans import (kmeans_parallel_init,
                                                     kmeans_plus_plus_init,
                                                     random_init)
    X = np.asarray(X)
    n, d = X.shape
    dt = X.dtype
    dtype = torch.float64 if dt == np.float64 else torch.float32
    plan = SweepPlan("kmeans", [dict(p) for p in points],
                     base={"k": int(k), "distance_type": distance_type,
                           "init": init, "max_iter": int(max_iter)})
    w = np.ones(n, dt) if sample_weight is None \
        else np.asarray(sample_weight, dt)
    data = np.concatenate([X, w[:, None]], axis=1)
    P_total = plan.num_points
    # a k axis is trace-shaping, so groups may differ in centroid
    # geometry: stacked to (P, k, d) only when uniform
    pop = _population(P_total, "centroids", "cluster_weights")
    groups = plan.groups()
    for gi, (tkey, idxs) in enumerate(groups):
        gcfg = dict(tkey)
        g_k = int(gcfg["k"])
        g_init = str(gcfg["init"]).upper()
        g_iter = int(gcfg["max_iter"])
        pts = [plan.points[i] for i in idxs]
        inits = []
        for pt in pts:
            s = int(pt.get("seed", seed))
            if g_init == "RANDOM":
                c0 = random_init(X, g_k, s)
            elif g_init in ("K_MEANS_PARALLEL", "KMEANS_PARALLEL"):
                c0 = kmeans_parallel_init(X, g_k, seed=s, env=env)
            else:
                c0 = kmeans_plus_plus_init(X, g_k, s)
            inits.append(c0.astype(dt))
        tols = [float(pt.get("tol", tol)) for pt in pts]
        stage = _make_kmeans_stage(len(idxs), g_k, str(gcfg["distance_type"]),
                                   g_iter, dtype, tols)
        ck_dir, rs = _group_paths(checkpoint_dir, resume_from, gi,
                                  len(groups))
        res = _run_sweep_queue(
            kind="kmeans", stage=stage, parts={"data": data},
            bcast={"swh_init_centroids": inits}, env=env, max_iter=g_iter,
            seed=int(seed),
            key_tail=(g_k, d, str(gcfg["distance_type"]), str(dt),
                      tuple(tols)),
            num_points=len(idxs), asha=_resolve_asha(asha, g_iter),
            checkpoint_dir=ck_dir, checkpoint_keep=checkpoint_keep,
            resume_from=rs)
        _collect(res, idxs, pop, gi,
                 host_lists=("centroids", "cluster_weights"))
    uniform = len({c.shape for c in pop["centroids"]}) == 1
    return SweepResult(
        trainer="kmeans", points=plan.points,
        values={"centroids": (np.stack(pop["centroids"]) if uniform
                              else pop["centroids"]),
                "cluster_weights": (np.stack(pop["cluster_weights"])
                                    if uniform else pop["cluster_weights"])},
        steps=pop["steps"], final_loss=pop["loss"], alive=pop["alive"],
        converged=pop["conv"], loss_curves=[np.zeros(0, dt)] * P_total,
        rungs=pop["rungs"], programs=len(groups))


# -- FTRL hyperparameter sweeps --------------------------------------------

@dataclass
class FtrlSweepResult:
    """Per-point outcomes of one FTRL staleness sweep.

    ``z``/``n``: (P, dim) final FTRL state per point, each lane bitwise a
    serial staleness drain with that point's hyperparameters and bitwise
    independent of the population; ``margins``: (P, total_rows)
    pre-update margins in arrival order; ``pv_logloss``: per-point
    progressive-validation log loss over the whole drain (the winner's
    lane); ``programs``: the distinct step configurations run (1 for a
    carry-resident grid); ``fallback``: True when a trace-shaping axis
    forced the recorded per-point path."""
    points: List[Dict[str, Any]]
    z: np.ndarray
    n: np.ndarray
    margins: np.ndarray
    pv_logloss: np.ndarray
    programs: int
    fallback: bool = False

    @property
    def num_points(self) -> int:
        return len(self.points)

    @property
    def best(self) -> int:
        """Lowest progressive-validation log loss, ties broken by lowest
        point index — deterministic and seed-free."""
        key = np.where(np.isfinite(self.pv_logloss), self.pv_logloss,
                       np.inf)
        return int(np.lexsort((np.arange(len(key)), key))[0])


def sweep_ftrl(batches, dim: int, points, base=None, env=None,
               coef0=None) -> FtrlSweepResult:
    """Sweep N FTRL hyperparameter points (alpha/beta/l1/l2) through the
    bounded-staleness step.

    ``batches``: padded-COO micro-batches ``[(idx, val, y), ...]`` (the
    FTRL encode convention: (B, width) int32 slots and values, (B,)
    labels, padding entries val == 0); ``dim``: model dimension;
    ``points``: per-point overrides over ``base``. Each micro-batch goes
    through :func:`~alink_tpu_torch.operator.stream.onlinelearning.ftrl.
    ftrl_staleness_step` once a point, in point order, on the state of
    that point (float64, on ``env``'s device). A ``staleness`` axis
    whose values all resolve equal keeps one configuration;
    heterogeneous values record ``alink_sweep_fallback_total{estimator=
    "ftrl"}`` and run each point with its own K (the same numbers); an
    ``update_mode`` other than "staleness" is refused. ``coef0``: the
    warm-start weights — each point's z starts at ``-coef0 * (beta/alpha
    + l2)``, as the serial drain's warm start does. The winner is the
    lowest progressive-validation log loss."""
    from ..common.mlenv import MLEnvironmentFactory
    from ..operator.stream.onlinelearning.ftrl import ftrl_staleness_step

    base = dict(base or {})
    base.setdefault("alpha", 0.1)
    base.setdefault("beta", 1.0)
    base.setdefault("l1", 0.0)
    base.setdefault("l2", 0.0)
    base.setdefault("staleness", 32)
    base.setdefault("update_mode", "staleness")
    plan = SweepPlan("ftrl", [dict(p) for p in points], base=base)
    modes = {str(p.get("update_mode", base["update_mode"]))
             for p in plan.points}
    if modes != {"staleness"}:
        # update_mode classifies as a trace axis so SweepPlan accepts
        # it, but this executor runs the bounded-staleness step only:
        # refuse rather than return another mode's point wrongly
        raise ValueError(
            f"sweep_ftrl sweeps the bounded-staleness kernel only; "
            f"update_mode values {sorted(modes - {'staleness'})} must "
            f"train through the serial drain (FtrlTrainStreamOp)")
    device = (env or MLEnvironmentFactory.get_default()).device
    P_pts = plan.num_points
    coef0 = np.zeros(dim) if coef0 is None else np.asarray(coef0)

    def resolved(i, name):
        return float(plan.points[i].get(name, base[name]))

    hyp = [(resolved(i, "alpha"), resolved(i, "beta"), resolved(i, "l1"),
            resolved(i, "l2")) for i in range(P_pts)]
    Ks = [int(plan.points[i].get("staleness", base["staleness"]))
          for i in range(P_pts)]
    fallback = len(set(Ks)) > 1
    if fallback:
        record_sweep_fallback(
            "ftrl", "trace-shaping-axis",
            f"staleness values {sorted(set(Ks))} split the chunk geometry "
            f"into {len(plan.groups())} compile groups — per-point steps "
            f"(identical numbers)")

    def z0_for(i):
        # the warm start encodes the initial weights into z at n = 0:
        # scale = beta/alpha + l2 depends on the point's hyperparameters
        alpha, beta, _, l2 = hyp[i]
        return torch.from_numpy(-coef0 * (beta / alpha + l2)).to(device)

    Z = [z0_for(i) for i in range(P_pts)]
    N = [torch.zeros(dim, dtype=torch.float64, device=device)
         for _ in range(P_pts)]
    margins: List[List[torch.Tensor]] = [[] for _ in range(P_pts)]
    for batch in batches:
        idx, val, y = (torch.as_tensor(a).to(device) for a in batch)
        for i in range(P_pts):
            Z[i], N[i], m = ftrl_staleness_step(idx, val, y, Z[i], N[i],
                                                *hyp[i], Ks[i])
            margins[i].append(m)
    Zh = np.stack([z.cpu().numpy() for z in Z])
    Nh = np.stack([n.cpu().numpy() for n in N])
    Mh = (np.stack([torch.cat(ms).cpu().numpy() for ms in margins])
          if batches else np.zeros((P_pts, 0)))
    programs = len(set(zip(hyp, Ks))) if fallback else 1
    return _finish_ftrl(plan, batches, Zh, Nh, Mh, programs, fallback)


def _finish_ftrl(plan, batches, Z, N, M, programs: int,
                 fallback: bool) -> FtrlSweepResult:
    """The progressive-validation log loss of each lane, on the host in
    float64."""
    y_all = (np.concatenate([torch.as_tensor(y).cpu().numpy()
                             for _, _, y in batches])
             if batches else np.zeros(0))
    if M.shape[1]:
        m = np.clip(M, -35.0, 35.0)
        ll = (np.logaddexp(0.0, -m) * y_all[None, :]
              + np.logaddexp(0.0, m) * (1.0 - y_all[None, :]))
        # a non-finite margin must surface in the lane's loss, not be
        # laundered by the clip: a diverged point's pv is NaN and ranks
        # last in `best`
        pv = np.where(np.isfinite(M).all(axis=1), ll.mean(axis=1),
                      np.nan)
    else:
        pv = np.full(M.shape[0], np.nan)
    return FtrlSweepResult(points=plan.points, z=Z, n=N, margins=M,
                           pv_logloss=pv, programs=programs,
                           fallback=fallback)
