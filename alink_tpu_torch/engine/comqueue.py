"""IterativeComQueue — the BSP superstep engine, eager, at one worker.

Counterpart: ``alink_tpu/engine/comqueue.py``. The JAX package traces
the stages into one ``lax.while_loop`` program under ``shard_map``. The
port runs the same loop eagerly on the session's device:

* superstep 1 is the init pass: it runs every stage (``is_init_step``
  is True) and builds the carry;
* then, while ``step < max_iter`` and no stop was signalled, the step
  count goes up by one and every stage runs again;
* a compare criterion, when set, runs after the stages of every
  superstep (the init pass included); its result is the one value the
  host reads per superstep. Without a criterion nothing is read until
  the queue ends.

Partitioned and broadcast data become tensors on the session's device
once, before superstep 1; at one worker a partition is the whole table
and ``__total_<name>`` holds its row count. Health probe series
(``ComContext.probe``) are kept in the carry and read through
:meth:`ComQueueResult.probe_series`; ``ALINK_TPU_HEALTH`` is latched
once a run (off: no probe, and no ``health_probes`` in the snapshot
signature). :meth:`IterativeComQueue.set_health` attaches a
``common/health.py::HealthMonitor``: at every checkpoint boundary it is
fed the probes of the carry the snapshot has just copied to the host
(no read of its own), and after the run those of the result; each
feeding ends in ``evaluate()``, whose ``HealthAlertError`` aborts the
run after the boundary's snapshot is on disk.

Durability (``engine/recovery.py``): :meth:`IterativeComQueue.
set_checkpoint` (or the constructor's ``checkpoint_dir`` /
``checkpoint_every`` / ``checkpoint_keep`` / ``resume_from``) persists
the carry at every ``every``-th superstep boundary and at the final
state; ``resume_from=`` re-enters a killed run at ``step + 1`` from its
newest valid snapshot, bit for bit. :meth:`IterativeComQueue.
set_boundary` runs a host hook every N supersteps, with or without a
checkpoint. ``set_program_key`` names the program in the snapshot
signature (eager PyTorch caches no program).

Telemetry, as in the JAX package: one ``comqueue.exec`` span a run,
``alink_comqueue_execs_total`` and ``alink_comqueue_supersteps_total``
(the supersteps this run executed: a resumed run's start after its
snapshot), and the collectives' series from
``engine/communication.py``. Not ported: the chunked and lowered
programs, donation, and the program-cache and cost gauges
(``alink_comqueue_program_cache_total``, ``alink_program_flops``,
``alink_program_bytes_accessed`` and the achieved rates), which wait for
a compile plane (ROADMAP A10(b)): eager PyTorch caches no program.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..common.health import health_enabled
from ..common.metrics import get_registry, metrics_enabled
from ..common.mlenv import MLEnvironment, MLEnvironmentFactory
from ..common.tracing import trace_span
from .communication import CommunicateFunction
from .context import ComContext


def freeze_config(v):
    """Hashable token of a config object (the JAX package's
    ``set_program_key`` helper). Arrays hash by content; objects by
    public attrs, recursively."""
    import dataclasses
    if v is None or isinstance(v, (bool, int, float, str, bytes)):
        return v
    if isinstance(v, (tuple, list)):
        return tuple(freeze_config(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted(((k, freeze_config(x)) for k, x in v.items()),
                            key=lambda kv: (type(kv[0]).__name__, repr(kv[0]))))
    if isinstance(v, np.ndarray) or (hasattr(v, "shape") and hasattr(v, "dtype")):
        a = np.asarray(v)
        raw = a.tobytes()
        if len(raw) > 512:
            import hashlib
            raw = hashlib.blake2b(raw, digest_size=16).digest()
        return ("nd", a.shape, str(a.dtype), raw)
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return (type(v).__name__, freeze_config(dataclasses.asdict(v)))
    if hasattr(v, "__dict__"):
        return (type(v).__name__,
                tuple(sorted((k, freeze_config(x)) for k, x in vars(v).items()
                             if not k.startswith("_"))))
    raise TypeError(f"freeze_config: cannot build a stable key from "
                    f"{type(v).__name__!r}; pass scalars, arrays, "
                    f"dataclasses, or objects with public __dict__ attrs")


def _program_label(program_key) -> str:
    """A short, bounded-cardinality label of a program key: its leading
    string (``("qn", ...)``, ``("kmeans", ...)``), else a digest."""
    if isinstance(program_key, (tuple, list)) and program_key \
            and isinstance(program_key[0], str):
        return program_key[0]
    import hashlib
    return hashlib.blake2b(repr(program_key).encode(),
                           digest_size=6).hexdigest()


class ComputeFunction:
    """One per-worker compute stage (reference comqueue/ComputeFunction.java)."""

    def calc(self, context: ComContext):  # pragma: no cover - interface
        raise NotImplementedError


class _FnStage(ComputeFunction):
    def __init__(self, fn: Callable[[ComContext], None], name: str = ""):
        self.fn = fn
        self.__name__ = name or getattr(fn, "__name__", "stage")

    def calc(self, context: ComContext):
        self.fn(context)


def _to_device(v, device: torch.device):
    """Input data as tensors on ``device``: numpy arrays and tensors are
    moved, containers recursed, other values kept."""
    if isinstance(v, torch.Tensor):
        return v.to(device)
    if isinstance(v, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(v)).to(device)
    if isinstance(v, dict):
        return {k: _to_device(x, device) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_to_device(x, device) for x in v)
    return v


def _to_host(v):
    """A carry value on the host: tensors as read-only numpy arrays,
    containers recursed, other values kept."""
    if isinstance(v, torch.Tensor):
        a = v.detach().cpu().numpy()
        a.flags.writeable = False
        return a
    if isinstance(v, dict):
        return {k: _to_host(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_to_host(x) for x in v)
    return v


def _stack1(v):
    """A host value with a leading worker axis of length 1."""
    if isinstance(v, np.ndarray):
        return v[None]
    if isinstance(v, dict):
        return {k: _stack1(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_stack1(x) for x in v)
    return np.asarray(v)[None]


class ComQueueResult:
    """The final carry of the one worker. :meth:`get` and :meth:`shards`
    fetch a carry object to the host on first use (read-only numpy
    arrays, memoized); the rest stays on the device."""

    def __init__(self, carry: Dict[str, Any], step_count: int):
        self._carry = carry
        self.step_count = step_count
        self._fetched: Dict[str, Any] = {}

    def get(self, name: str):
        """The value of carry object ``name`` on the host."""
        if name not in self._fetched:
            if name not in self._carry:
                raise KeyError(f"no carry object '{name}'; "
                               f"have {sorted(self._carry)}")
            self._fetched[name] = _to_host(self._carry[name])
        return self._fetched[name]

    def shards(self, name: str):
        """The per-worker values stacked on a leading axis: ``(1, ...)``."""
        return _stack1(self.get(name))

    def keys(self):
        return [k for k in self._carry if not k.startswith("__")]

    # -- health probe channel ----------------------------------------------
    def probe_names(self):
        """Names published via ``ctx.probe`` during the run (sorted)."""
        pre = ComContext.PROBE_PREFIX
        return sorted(k[len(pre):] for k in self._carry if k.startswith(pre))

    def probe_series(self, name: str, trim: bool = True):
        """One probe's per-superstep series; with ``trim`` the NaN prefill
        past the executed step count is cut, so ``series[i]`` is superstep
        ``i + 1``'s value."""
        s = self.get(ComContext.PROBE_PREFIX + name)
        return s[:self.step_count] if trim else s

    def probes(self, trim: bool = True):
        """Every probe series as ``{name: (steps,) array}`` (read-only)."""
        return {n: self.probe_series(n, trim=trim) for n in self.probe_names()}


class IterativeComQueue:
    def __init__(self, env: Optional[MLEnvironment] = None, max_iter: int = 100,
                 seed: int = 0, checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 1, checkpoint_keep: int = 3,
                 resume_from: Optional[str] = None):
        self.env = env
        self.max_iter = max_iter
        self.seed = seed
        self._stages: List[Any] = []
        self._partitioned: Dict[str, Any] = {}
        self._broadcast: Dict[str, Any] = {}
        self._criterion: Optional[Callable[[ComContext], Any]] = None
        self._close: Optional[Callable[[ComQueueResult], Any]] = None
        self._program_key = None
        self._ckpt = None
        self._boundary = None     # (every, hook): set_boundary
        self._health = None       # HealthMonitor: set_health
        if checkpoint_dir is not None:
            self.set_checkpoint(checkpoint_dir, every=checkpoint_every,
                                keep_last=checkpoint_keep,
                                resume_from=resume_from)
        elif resume_from is not None:
            raise ValueError("resume_from= requires checkpoint_dir= "
                             "(an explicit resume request must not "
                             "silently retrain from scratch)")

    # -- construction API (mirrors BaseComQueue.java:75-148) --------------
    def init_with_partitioned_data(self, name: str, data) -> "IterativeComQueue":
        self._partitioned[name] = data
        return self

    def init_with_broadcast_data(self, name: str, data) -> "IterativeComQueue":
        self._broadcast[name] = data
        return self

    def add(self, stage) -> "IterativeComQueue":
        if callable(stage) and not isinstance(
                stage, (ComputeFunction, CommunicateFunction)):
            stage = _FnStage(stage)
        self._stages.append(stage)
        return self

    def set_compare_criterion(self, fn) -> "IterativeComQueue":
        """Stop when ``fn(context)`` is truthy (a bool or a 0-d tensor)."""
        self._criterion = fn
        return self

    def set_max_iter(self, n: int) -> "IterativeComQueue":
        self.max_iter = n
        return self

    def close_with(self, fn: Callable[[ComQueueResult], Any]) -> "IterativeComQueue":
        self._close = fn
        return self

    def set_program_key(self, key) -> "IterativeComQueue":
        """Name the program: eager PyTorch compiles none, so the key only
        enters the checkpoint signature (:func:`freeze_config`), where it
        tells apart programs whose stages share their names (L-BFGS and
        OWLQN, objectives of other losses)."""
        self._program_key = freeze_config(key)
        return self

    def set_checkpoint(self, directory: str, every: int = 1,
                       keep_last: int = 3,
                       resume_from: Optional[str] = None
                       ) -> "IterativeComQueue":
        """Persist the superstep carry every ``every`` supersteps (and at
        the final state) under ``directory``: durable, checksummed,
        atomically published snapshots (``common/checkpoint.py``).
        ``resume_from=`` restarts a killed run from its newest valid
        snapshot with bitwise-identical results (``engine/recovery.py``)."""
        from .recovery import CheckpointConfig
        self._ckpt = CheckpointConfig(directory=str(directory),
                                      every=int(every),
                                      keep_last=int(keep_last),
                                      resume_from=resume_from)
        return self

    def set_boundary(self, every: int, hook) -> "IterativeComQueue":
        """Run a host hook every ``every`` supersteps: ``hook(carry, step)
        -> carry | None`` may replace the carry between supersteps
        (``None`` keeps it); the compare criterion is then read again.
        With :meth:`set_checkpoint` the boundary cadence wins and the hook
        runs right after each snapshot is handed over, and again after a
        resume, so a resumed run re-derives the same deterministic
        decisions. Without a checkpoint nothing is persisted."""
        if int(every) < 1:
            raise ValueError(f"set_boundary(every=) must be >= 1, "
                             f"got {every}")
        self._boundary = (int(every), hook)
        return self

    def set_health(self, monitor) -> "IterativeComQueue":
        """Attach a ``common.health.HealthMonitor``: after the run (and,
        for checkpointed runs, at every snapshot boundary, on the carry
        the snapshot has already copied to the host) the engine feeds it
        every ``ctx.probe`` series and calls ``evaluate()``. A monitor
        with ``raise_on={"critical"}`` therefore aborts a poisoned
        checkpointed run at the next boundary, with that boundary's
        snapshot published. No-op when ``ALINK_TPU_HEALTH`` is off
        (stages record no probes)."""
        self._health = monitor
        return self

    @staticmethod
    def _ingest_probes(monitor, host, step):
        """Feed the probe prefix of a host carry (a snapshot payload) to
        a HealthMonitor and evaluate."""
        pre = ComContext.PROBE_PREFIX
        series = {k[len(pre):]: np.asarray(v)[:int(step)]
                  for k, v in host.items() if k.startswith(pre)}
        if series:
            monitor.ingest(series)
            monitor.evaluate()

    # -- execution --------------------------------------------------------
    def _stages_digest(self) -> tuple:
        """The stages' names in order, with each communication stage's
        public settings, and the criterion's name."""
        items = []
        for s in self._stages:
            if isinstance(s, _FnStage):
                items.append(("fn", getattr(s.fn, "__qualname__",
                                            s.__name__)))
            else:
                items.append((type(s).__qualname__, freeze_config(
                    {k: v for k, v in vars(s).items()
                     if not k.startswith("_")})))
        if self._criterion is not None:
            items.append(("criterion", getattr(self._criterion,
                                               "__qualname__", "?")))
        return tuple(items)

    def _signature(self, max_iter: int, probes_on: bool):
        from .recovery import data_digest, program_signature
        parts = self._partitioned
        part_sig = tuple(
            (k, tuple(map(int, np.shape(parts[k]))),
             str(getattr(parts[k], "dtype", "?")))
            for k in sorted(parts))
        return program_signature(
            num_workers=1, max_iter=max_iter, seed=self.seed,
            part_sig=part_sig, bcast_names=tuple(sorted(self._broadcast)),
            stages_digest=self._stages_digest(),
            program_key=self._program_key,
            data_token=data_digest({"parts": parts,
                                    "bcast": self._broadcast}),
            probes_on=probes_on)

    def exec(self):
        # one root span a run: the snapshot spans and instants of its
        # boundaries nest under it
        with trace_span("comqueue.exec", cat="engine") as sp:
            sp.set(max_iter=int(self.max_iter),
                   program=_program_label(self._program_key)
                   if self._program_key is not None else "uncached")
            return self._run()

    def _run(self):
        env = self.env or MLEnvironmentFactory.get_default()
        device = env.device
        max_iter = int(self.max_iter)
        ck = self._ckpt
        probes_on = health_enabled()
        if self._boundary is not None:
            import dataclasses
            from .recovery import CheckpointConfig
            b_every = self._boundary[0]
            ck = CheckpointConfig(directory=None, every=b_every) \
                if ck is None else dataclasses.replace(ck, every=b_every)
        resumed = signature = None
        if ck is not None and (ck.directory or ck.resume_from):
            from .recovery import resume_state
            signature = self._signature(max_iter, probes_on)
            resumed = resume_state(ck, signature)
        static: Dict[str, Any] = {}
        for k, arr in self._partitioned.items():
            static[k] = _to_device(arr, device)
            static[f"__total_{k}"] = int(static[k].shape[0])
        for k, v in self._broadcast.items():
            static[k] = _to_device(v, device)
        carry: Dict[str, Any] = {}
        derived: Dict[str, Any] = {}
        entry = 1 if resumed is None else int(resumed[1]["step"]) + 1

        def context(step):
            return ComContext(carry, static, device, step, self.seed,
                              max_iter, derived, entry, probes_on)

        def criterion(step) -> bool:
            return (self._criterion is not None
                    and bool(self._criterion(context(step))))

        def superstep(step) -> bool:
            ctx = context(step)
            for s in self._stages:
                s.calc(ctx)
            return criterion(step)

        if ck is None:
            step = 1
            while not superstep(step) and step < max_iter:
                step += 1
        else:
            from .recovery import drive
            on_snapshot = None
            if self._health is not None and probes_on:
                # the mid-run watchdog reads the carry the boundary's
                # snapshot has just copied to the host; a HealthAlertError
                # aborts the run after that snapshot is published
                def on_snapshot(host, step, _m=self._health):
                    self._ingest_probes(_m, host, step)
            step = drive(ck, superstep=superstep, criterion=criterion,
                         carry=carry, max_iter=max_iter, signature=signature,
                         device=device, resumed=resumed,
                         on_boundary=None if self._boundary is None
                         else self._boundary[1], on_snapshot=on_snapshot)
        result = ComQueueResult(carry, step)
        if metrics_enabled():
            reg = get_registry()
            reg.inc("alink_comqueue_execs_total", 1)
            reg.inc("alink_comqueue_supersteps_total",
                    step - (entry - 1))
        if self._health is not None and probes_on \
                and result.probe_names():
            # the final pass (after a checkpointed run's last boundary it
            # evaluates again; the monitor dedupes its alerts)
            self._health.ingest_result(result)
            self._health.evaluate()
        if self._close is not None:
            return self._close(result)
        return result
