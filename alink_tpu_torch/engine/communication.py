"""Collectives of the BSP engine at one worker.

Counterpart: ``alink_tpu/engine/communication.py``. The signatures are
the JAX package's, so trainer code reads the same; at one worker every
reduction is the identity and an untiled gather adds the worker axis
of length 1. ``manifest_psum_scatter`` and ``manifest_all_gather`` (ALS'
``shard_solve``) follow ``lax.psum_scatter`` and ``lax.all_gather`` at
one worker: tiled, both are the identity; untiled, the scatter drops
its length-1 worker axis and the gather adds one. Several workers
raise.

Telemetry: every wrapper call records its collective through
:func:`record_collective` — ``alink_collective_calls_total`` and
``alink_collective_logical_bytes_total`` (the payload summed over the
workers) by ``collective`` — as the JAX package charges its traced
manifest once an executed superstep; the eager engine calls the
wrappers once a superstep, so the counts agree. Not ported: the
fusion of adjacent reductions and its series
(``alink_collective_fused_total``, ``_payload_fused_bytes``; ROADMAP
A9): there is nothing to fuse at one worker. The stage-level
``AllReduce`` is ported for the optimizers; ``AllGather`` and
``BroadcastFromWorker0`` wait for a caller.
"""

from __future__ import annotations

import torch

from ..common.metrics import get_registry, metrics_enabled
from .context import ComContext


def payload_nbytes(value) -> int:
    """Logical payload bytes of a buffer (a tensor, or a list, tuple or
    dict of them) as seen by one worker."""
    if isinstance(value, torch.Tensor):
        return value.numel() * value.element_size()
    if isinstance(value, dict):
        return sum(payload_nbytes(v) for v in value.values())
    if isinstance(value, (list, tuple)):
        return sum(payload_nbytes(v) for v in value)
    return 8


def record_collective(kind: str, per_worker_bytes: int,
                      num_workers: int) -> None:
    """Record one collective invocation: its logical bytes are the
    payload summed over the workers."""
    if metrics_enabled():
        reg = get_registry()
        lbl = {"collective": kind}
        reg.inc("alink_collective_calls_total", 1, lbl)
        reg.inc("alink_collective_logical_bytes_total",
                int(per_worker_bytes) * int(num_workers), lbl)


def _one_worker(name: str, num_workers: int) -> None:
    if num_workers != 1:
        raise NotImplementedError(
            f"{name}: {num_workers} workers; the port's engine runs one")


def manifest_psum(x, axis_name, *, name: str = "<psum>",
                  num_workers: int = 1):
    """``lax.psum`` at one worker: the identity."""
    _one_worker(name, num_workers)
    record_collective("AllReduce", payload_nbytes(x), num_workers)
    return x


def manifest_pmax(x, axis_name, *, name: str = "<pmax>",
                  num_workers: int = 1):
    """``lax.pmax`` at one worker: the identity."""
    _one_worker(name, num_workers)
    record_collective("AllReduce", payload_nbytes(x), num_workers)
    return x


def manifest_pmin(x, axis_name, *, name: str = "<pmin>",
                  num_workers: int = 1):
    """``lax.pmin`` at one worker: the identity."""
    _one_worker(name, num_workers)
    record_collective("AllReduce", payload_nbytes(x), num_workers)
    return x


def manifest_all_gather(x, axis_name, *, axis: int = 0, tiled: bool = False,
                        name: str = "<all_gather>", num_workers: int = 1):
    """``lax.all_gather`` at one worker: the identity when ``tiled``, else
    ``x`` with a worker axis of length 1 inserted at ``axis``."""
    _one_worker(name, num_workers)
    record_collective("AllGather", payload_nbytes(x), num_workers)
    return x if tiled else x.unsqueeze(axis)


def manifest_psum_scatter(x, axis_name, *, scatter_dimension: int = 0,
                          tiled: bool = False,
                          name: str = "<psum_scatter>",
                          num_workers: int = 1):
    """``lax.psum_scatter`` at one worker: the identity when ``tiled``;
    untiled, ``x``'s ``scatter_dimension`` must have the worker count's
    length 1 and is dropped."""
    _one_worker(name, num_workers)
    record_collective("ReduceScatter", payload_nbytes(x), num_workers)
    if tiled:
        return x
    if x.shape[scatter_dimension] != num_workers:
        raise ValueError(
            f"{name}: untiled psum_scatter needs dimension "
            f"{scatter_dimension} of length {num_workers}, got "
            f"{tuple(x.shape)}")
    return x.squeeze(scatter_dimension)


class CommunicateFunction:
    """Marker base (reference comqueue/CommunicateFunction.java)."""

    def calc(self, context: ComContext):  # pragma: no cover - interface
        raise NotImplementedError


class AllReduce(CommunicateFunction):
    """All-reduce named carry buffers across workers (reference
    communication/AllReduce.java:85-120, SUM/MAX/MIN :125-159): the
    identity at one worker, routed through the manifest wrappers as in
    the JAX package."""

    OPS = ("sum", "max", "min")

    def __init__(self, *buffer_names: str, op: str = "sum",
                 mean: bool = False):
        if not buffer_names:
            raise ValueError("AllReduce needs at least one buffer name")
        self.buffer_names = buffer_names
        if op.lower() not in self.OPS:
            raise ValueError(f"unsupported allreduce op {op}; use sum/max/min")
        self.op = op.lower()
        if mean and self.op != "sum":
            raise ValueError("mean=True only makes sense with op='sum'")
        self.mean = mean

    def calc(self, context: ComContext):
        wrap = {"sum": manifest_psum, "max": manifest_pmax,
                "min": manifest_pmin}[self.op]
        for name in self.buffer_names:
            out = wrap(context.get_obj(name), ComContext.AXIS, name=name,
                       num_workers=context.num_task)
            if self.mean:
                out = _divide(out, context.num_task)
            context.put_obj(name, out)


def _divide(value, n: int):
    """A buffer (a tensor, or a dict of them, as Word2Vec's two-leaf
    ``emb``) divided by the worker count: the identity at one worker."""
    if n == 1:
        return value
    if isinstance(value, dict):
        return {k: _divide(v, n) for k, v in value.items()}
    return value / n
