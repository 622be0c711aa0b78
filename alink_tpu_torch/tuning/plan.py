"""SweepPlan — hyperparameter classification and compile-group planning.

Counterpart: ``alink_tpu/tuning/plan.py``, copied (it imports only
``dataclasses``). A swept parameter is either:

* **carry-resident** — its value enters the sweep as DATA (a
  ``(points,)`` lane read by the per-point step): step size,
  regularization strength, convergence tolerance, the SGD mini-batch
  fraction, the k-means init seed (which only shapes the host-computed
  stacked init centroids). Any number of points sweep these in ONE
  group;
* **trace-shaping** — its value changes the program's geometry or its
  op graph: the optimizer method (LBFGS's ring buffers vs SGD's
  sampling), ``max_iter`` (preallocated curve length), the engine seed,
  k / distance metric for k-means. Points that differ in a
  trace-shaping parameter land in separate **compile groups**, one
  queue per group.

A sweep's program count therefore equals the number of trace-shaping
groups, independent of population size and of the ASHA rung schedule.
In the port a group is one eager ``IterativeComQueue`` (nothing is
compiled), and it shares the design's run plan across its points.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple

__all__ = ["CARRY_RESIDENT", "TRACE_SHAPING", "AshaConfig", "SweepPlan",
           "classify_param"]

# Per-trainer parameter classification. "optimizer" covers the five
# iterative trainers behind OptimParams (LBFGS/OWLQN/GD/SGD/Newton);
# "kmeans" covers kmeans_train; "ftrl" covers the online FTRL staleness
# step (sweep_ftrl). Names are the OptimParams / kmeans_train /
# FtrlTrainStreamOp keyword names (l1/l2 ride the objective in the
# serial path but sweep as per-point lanes through the parameterized
# kernels; FTRL's alpha/beta/l1/l2 enter the weights closed form as
# pure data).
CARRY_RESIDENT: Dict[str, frozenset] = {
    "optimizer": frozenset({"learning_rate", "epsilon", "l1", "l2",
                            "mini_batch_fraction"}),
    "kmeans": frozenset({"tol", "seed"}),
    "ftrl": frozenset({"alpha", "beta", "l1", "l2"}),
}

TRACE_SHAPING: Dict[str, frozenset] = {
    "optimizer": frozenset({"method", "max_iter", "seed"}),
    "kmeans": frozenset({"k", "distance_type", "init", "max_iter"}),
    # the staleness bound is the scan chunk length — program geometry
    "ftrl": frozenset({"staleness", "update_mode"}),
}


def classify_param(trainer: str, name: str) -> str:
    """``"carry"`` or ``"trace"`` for a swept parameter; raises KeyError
    for a name the sweep engine does not understand (callers must fall
    back to the serial loop, recorded — never guess)."""
    if trainer not in CARRY_RESIDENT:
        raise KeyError(f"unknown sweep trainer {trainer!r}; "
                       f"have {sorted(CARRY_RESIDENT)}")
    if name in CARRY_RESIDENT[trainer]:
        return "carry"
    if name in TRACE_SHAPING[trainer]:
        return "trace"
    raise KeyError(f"{trainer}: unknown sweep parameter {name!r} "
                   f"(carry-resident: {sorted(CARRY_RESIDENT[trainer])}; "
                   f"trace-shaping: {sorted(TRACE_SHAPING[trainer])})")


@dataclass(frozen=True)
class AshaConfig:
    """ASHA successive halving (Li et al., "A System for Massively
    Parallel Hyperparameter Tuning", MLSys 2020; generalizing Hyperband,
    Li et al., JMLR 2018) mapped onto the engine's boundaries.

    ``rung``       — supersteps between rungs; each rung is a boundary
                     of ``IterativeComQueue.set_boundary`` (where
                     checkpoints are taken too), so pruning reads the
                     per-point loss lanes once a rung, with no read
                     inside a superstep;
    ``eta``        — keep the top ``ceil(alive/eta)`` points per rung;
    ``min_points`` — never prune below this many live points.

    Pruning flips a carry-resident boolean lane; the group's geometry
    never changes as the population shrinks, and the decision is
    deterministic and seed-free: points rank by (loss, point index) —
    NaN losses sort last — so the same grid always yields the same
    survivors.
    """
    rung: int
    eta: int = 3
    min_points: int = 1

    def __post_init__(self):
        if int(self.rung) < 1:
            raise ValueError(f"AshaConfig.rung must be >= 1, got {self.rung}")
        if int(self.eta) < 2:
            raise ValueError(f"AshaConfig.eta must be >= 2, got {self.eta}")
        if int(self.min_points) < 1:
            raise ValueError(f"AshaConfig.min_points must be >= 1, "
                             f"got {self.min_points}")


@dataclass
class SweepPlan:
    """A validated sweep: trainer family + per-point override dicts.

    ``points`` are ``{param_name: value}`` overrides on top of the
    caller's base configuration; every name must classify (carry or
    trace) for ``trainer``. :meth:`groups` partitions the points into
    compile groups keyed by their trace-shaping values, preserving
    point order inside each group (the deterministic tie-break relies
    on stable point indices).
    """
    trainer: str
    points: List[Dict[str, Any]]
    base: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        if not self.points:
            raise ValueError("SweepPlan needs at least one point")
        for i, pt in enumerate(self.points):
            for name in pt:
                classify_param(self.trainer, name)   # raises on unknown

    # ------------------------------------------------------------------
    def carry_axes(self) -> List[str]:
        names = set()
        for pt in self.points:
            names.update(n for n in pt
                         if n in CARRY_RESIDENT[self.trainer])
        return sorted(names)

    def trace_axes(self) -> List[str]:
        names = set()
        for pt in self.points:
            names.update(n for n in pt
                         if n in TRACE_SHAPING[self.trainer])
        return sorted(names)

    def _trace_key(self, pt: Dict[str, Any]) -> Tuple:
        """The compile-group identity of one point: its resolved
        trace-shaping values (base-filled, so an explicit override equal
        to the base value lands in the base group, not a duplicate)."""
        return tuple(
            (n, pt.get(n, self.base.get(n)))
            for n in sorted(TRACE_SHAPING[self.trainer]))

    def groups(self) -> List[Tuple[Tuple, List[int]]]:
        """``[(trace_key, [point indices])]`` in first-seen order.

        len(groups()) is the number of sweep programs (queues) this
        plan needs — the acceptance invariant: independent of the
        population size and of any ASHA schedule.
        """
        order: List[Tuple] = []
        members: Dict[Tuple, List[int]] = {}
        for i, pt in enumerate(self.points):
            k = self._trace_key(pt)
            if k not in members:
                members[k] = []
                order.append(k)
            members[k].append(i)
        return [(k, members[k]) for k in order]

    @property
    def num_points(self) -> int:
        return len(self.points)
