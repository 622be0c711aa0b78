"""Collectives of the BSP engine at one worker.

Counterpart: ``alink_tpu/engine/communication.py``. The signatures are
the JAX package's, so trainer code reads the same; at one worker every
reduction is the identity and a gather adds the worker axis of length
1. The collective manifest, the fusion of adjacent reductions and the
ReduceScatter helper are not ported: there is nothing to count or fuse
until the engine runs on several cards (ROADMAP A12). The stage-level
``AllReduce``, ``AllGather`` and ``BroadcastFromWorker0`` wait for a
caller: the port's trainers reduce inside their stages with
:func:`manifest_psum` / ``ComContext.all_reduce_sum``.
"""

from __future__ import annotations

from .context import ComContext


def _one_worker(name: str, num_workers: int) -> None:
    if num_workers != 1:
        raise NotImplementedError(
            f"{name}: {num_workers} workers; the port's engine runs one")


def manifest_psum(x, axis_name, *, name: str = "<psum>",
                  num_workers: int = 1):
    """``lax.psum`` at one worker: the identity."""
    _one_worker(name, num_workers)
    return x


def manifest_pmax(x, axis_name, *, name: str = "<pmax>",
                  num_workers: int = 1):
    """``lax.pmax`` at one worker: the identity."""
    _one_worker(name, num_workers)
    return x


def manifest_pmin(x, axis_name, *, name: str = "<pmin>",
                  num_workers: int = 1):
    """``lax.pmin`` at one worker: the identity."""
    _one_worker(name, num_workers)
    return x


class CommunicateFunction:
    """Marker base (reference comqueue/CommunicateFunction.java)."""

    def calc(self, context: ComContext):  # pragma: no cover - interface
        raise NotImplementedError
