"""ComContext — the per-worker state handle inside a superstep.

Counterpart: ``alink_tpu/engine/context.py``. There the carry is a
pytree traced through ``lax.while_loop`` and ``task_id`` is the mesh
axis index. Here the engine runs eagerly at one worker: the carry is a
plain dict of tensors (and whatever else a stage stores), ``task_id`` is
0, ``num_task`` is 1 and ``step_no`` is a Python int starting at 1.
Partitioned and broadcast data are read-only entries beside the carry,
and so are the derived entries (:meth:`ComContext.put_derived`):
data-derived objects a stage builds on the run's entry superstep
(:attr:`ComContext.is_entry_step`) that a snapshot does not hold.
Health probes ride the carry as in the JAX package: one float32
``(max_iter,)`` series per probe, prefilled with NaN and written at
``step_no - 1`` on the device, with no host read. ``ALINK_TPU_HEALTH``
(``common/health.py``, default on), latched once a run by the engine,
switches them off: :meth:`ComContext.probe` is then a no-op and
:attr:`ComContext.probes_enabled` lets a stage skip probe-only
arithmetic. ``IterativeComQueue.set_health`` feeds the series to a
``HealthMonitor``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch


class ComContext:
    AXIS = "d"

    # carry-key prefix of the probe channel (engine + result accessors)
    PROBE_PREFIX = "__probe_"
    # probe series dtype: monitoring scalars, not model state
    PROBE_DTYPE = torch.float32

    def __init__(self, carry: Dict[str, Any], static: Dict[str, Any],
                 device: torch.device, step_no: int, seed: int,
                 max_iter: int = 0, derived: Optional[Dict[str, Any]] = None,
                 entry_step: int = 1, probes_on: bool = True):
        self._carry = carry
        self._static = static
        self._derived = {} if derived is None else derived
        self._entry_step = int(entry_step)
        self._device = device
        self._step_no = int(step_no)
        self._seed = int(seed)
        self._max_iter = int(max_iter)
        self._probes_on = bool(probes_on) and self._max_iter > 0

    # -- identity --------------------------------------------------------
    @property
    def task_id(self) -> int:
        """Worker index (Flink getTaskId analogue): 0 at one worker."""
        return 0

    @property
    def num_task(self) -> int:
        return 1

    @property
    def step_no(self) -> int:
        """1-based superstep number (reference ComContext.getStepNo)."""
        return self._step_no

    @property
    def is_init_step(self) -> bool:
        """True during superstep 1, where stages allocate their state
        (the reference's ``if (context.getStepNo() == 1)`` idiom)."""
        return self._step_no == 1

    @property
    def is_entry_step(self) -> bool:
        """True on the first superstep this run executes: the init pass,
        or the superstep after the one a resumed run's snapshot holds.
        Data-derived objects (:meth:`put_derived`) are built here."""
        return self._step_no == self._entry_step

    @property
    def device(self) -> torch.device:
        return self._device

    # -- state -----------------------------------------------------------
    def get_obj(self, name: str):
        if name in self._carry:
            return self._carry[name]
        if name in self._derived:
            return self._derived[name]
        if name in self._static:
            return self._static[name]
        raise KeyError(f"ComContext: no object '{name}' "
                       f"(carry keys: {sorted(self._carry)}, "
                       f"static keys: {sorted(self._static)})")

    def put_obj(self, name: str, value):
        if name in self._static or name in self._derived:
            raise ValueError(f"'{name}' is immutable partitioned/broadcast "
                             f"data or a derived object")
        self._carry[name] = value

    def put_derived(self, name: str, value):
        """Keep a data-derived object for the rest of the run, outside the
        carry: a snapshot does not hold it, so a stage builds it on the
        entry superstep (:attr:`is_entry_step`), fresh or resumed."""
        if name in self._static or name in self._carry:
            raise ValueError(f"'{name}' is partitioned/broadcast data or a "
                             f"carry object")
        self._derived[name] = value

    def contains_obj(self, name: str) -> bool:
        return (name in self._carry or name in self._derived
                or name in self._static)

    def remove_obj(self, name: str):
        self._carry.pop(name, None)

    # -- health probes ---------------------------------------------------
    @property
    def probes_enabled(self) -> bool:
        """The run's ``ALINK_TPU_HEALTH`` switch. A stage may branch on it
        to skip probe-only arithmetic."""
        return self._probes_on

    def probe(self, name: str, value) -> None:
        """Record one named per-superstep scalar: series ``name`` (float32,
        ``(max_iter,)``, NaN where no superstep wrote) gets ``value`` at
        ``step_no - 1``. The write stays on the device. As in the JAX
        package, a probe must first be recorded in the init pass. A no-op
        while the switch is off."""
        if not self._probes_on:
            return
        key = self.PROBE_PREFIX + name
        v = torch.as_tensor(value, device=self._device).to(
            self.PROBE_DTYPE).reshape(())
        series = self._carry.get(key)
        if series is None:
            if not self.is_init_step:
                raise KeyError(
                    f"probe '{name}' first recorded after the init pass; "
                    f"record every probe while ctx.is_init_step is True")
            series = torch.full((self._max_iter,), float("nan"),
                                dtype=self.PROBE_DTYPE, device=self._device)
            self._carry[key] = series
        series[self._step_no - 1] = v

    def probe_nonfinite(self, name: str, value: torch.Tensor) -> None:
        """Probe the count of non-finite elements of a tensor as series
        ``nonfinite.<name>``."""
        if not self._probes_on:
            return
        self.probe("nonfinite." + name,
                   value.numel() - torch.isfinite(value).sum())

    # -- communication ---------------------------------------------------
    def all_reduce_sum(self, value):
        """In-stage all-reduce (communication/AllReduce.java:85-120): the
        identity at one worker."""
        return value

    # -- randomness ------------------------------------------------------
    def rng(self) -> torch.Generator:
        """A fresh per-worker, per-step generator on the session's
        device, seeded from (queue seed, step, task). It replaces the
        JAX package's ``rng_key()``: its draws differ from JAX's PRNG by
        design (and a CUDA generator's from a CPU one's), so tests
        compare random paths by their properties, not their bits."""
        state = np.random.SeedSequence(
            [self._seed, self._step_no, self.task_id]).generate_state(
                1, np.uint64)[0]
        gen = torch.Generator(device=self._device)
        gen.manual_seed(int(state))
        return gen
