"""ServingPlan — ONE hashable key object for the serving tier.

Counterpart: ``alink_tpu/serving/plan.py``, copied. The JAX package
derives every compiled-program cache key from its plan. The port
compiles no program (the kernels take any row count), so here the plan
keys what stands in for the program cache:

* ``CompiledPredictor`` resolves its plan ONCE at construction and
  derives the key of its bucket accounting from
  :meth:`ServingPlan.program_key` — a (signature, kind, bucket,
  trailing shapes, bucket set) key counts a miss at its first dispatch
  and a hit after that, so ``cache_stats`` and ``bucket_hit_rate``
  count what the JAX package's program cache counts on the same
  request sequence;
* :meth:`ServingPlan.swap_signature` — a JSON-stable string of the
  serving geometry, the identity a swap keeps (``swap_weights``
  refuses arrays of another geometry).

The plan is a FROZEN dataclass of already-resolved values — it never
reads flags or the environment itself. ``sharded`` and ``mesh_fp`` stay
``False`` / ``None`` until multi-GPU serving (ROADMAP A9); they are kept
so the keys have the JAX package's shape.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

__all__ = ["ServingPlan"]


@dataclass(frozen=True)
class ServingPlan:
    """The resolved serving-program identity.

    ``signature`` — the :class:`~alink_tpu_torch.serving.predictor.
    ServingKernel` signature: model geometry, label arity, ship dtype
    and resolved serve dtype (the mapper's ``serving_kernel`` folds
    ``ALINK_TPU_SERVE_DTYPE`` into it).
    ``buckets``   — the resolved shape-bucket set; the per-dispatch
    bucket is a separate ``program_key`` dimension, the SET rides the
    plan so two predictors with different bucket grids never alias.
    ``sharded``   — the resolved multi-chip mode (a request for
    sharding that the kernel cannot satisfy resolves to ``False``).
    ``mesh_fp``   — the serving mesh fingerprint (device ids + axis
    names) when sharded; ``None`` single-device.
    """

    signature: Tuple
    buckets: Tuple[int, ...]
    sharded: bool = False
    mesh_fp: Optional[Tuple] = None

    def __post_init__(self):
        object.__setattr__(self, "buckets", tuple(self.buckets))
        if self.mesh_fp is not None:
            object.__setattr__(self, "mesh_fp", tuple(self.mesh_fp))

    # -- derived keys ---------------------------------------------------
    def geometry_key(self) -> Tuple:
        """Everything that decides whether two models serve through the
        same bucket shapes — kernel signature (model geometry x encoding
        dtype) x bucket set x sharded mode x mesh identity (the JAX
        package's fleet groups tenants on it)."""
        return (self.signature, self.buckets, bool(self.sharded),
                self.mesh_fp)

    def program_key(self, kind: str, bucket: int,
                    trailing_shapes: Tuple, *,
                    signature: Optional[Tuple] = None,
                    sharded: Optional[bool] = None,
                    lanes: Optional[int] = None) -> Tuple:
        """One dispatch shape's key (the JAX package's program-cache key).

        ``signature``/``sharded`` override the plan's own values for a
        HOT-SWAPPED model version whose kernel differs from the
        construction-time one (a different geometry swapped in counts
        its own keys) — the per-version truth must ride the key, the
        plan carries the predictor-level resolution. ``lanes`` is the
        JAX package's fleet lane bucket (``None`` = one model)."""
        sig = self.signature if signature is None else signature
        sh = self.sharded if sharded is None else bool(sharded)
        # mesh identity stays the LAST element, as in the JAX package
        return (sig, str(kind), int(bucket), tuple(trailing_shapes),
                self.buckets, None if lanes is None else int(lanes),
                self.mesh_fp if sh else None)

    def swap_signature(self) -> str:
        """JSON-stable geometry identity for swap/snapshot validation
        (a snapshot's ``meta["signature"]`` in ``common/checkpoint.py``
        semantics)."""
        return repr(self.geometry_key())

    def with_signature(self, signature: Tuple) -> "ServingPlan":
        """The same plan serving a different kernel geometry (the
        hot-swap path: buckets/mesh stay, the model signature moves)."""
        return replace(self, signature=tuple(signature))
