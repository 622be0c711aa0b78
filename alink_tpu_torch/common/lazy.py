"""Lazy evaluation: deferred callbacks that fire at ``execute()``.

Counterpart: ``alink_tpu/common/lazy.py`` (the re-design of the
reference's common/lazy/LazyEvaluation.java:17-60 and
LazyObjectsManager.java:23-75, fired by
BatchOperator.triggerLazyEvaluation, batch/BatchOperator.java:497-547).
Operators compute eagerly; ``lazy_print`` / ``lazy_collect`` register
consumers of a value already computed, and ``execute()`` hands it to
them once.

The port's difference: the JAX package keeps the manager on the session
(``MLEnvironment.lazy_objects_manager``). The port's ``MLEnvironment()``
resolves its device when it is built, so the default session raises on a
machine without a card; the manager therefore lives here, one for the
process (:func:`lazy_objects_manager`), and reaching it resolves
nothing. A host op's ``lazy_print`` works without a card.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List


class LazyEvaluation:
    """Holds a future value plus callbacks; replays value to late subscribers."""

    def __init__(self):
        self._callbacks: List[Callable[[Any], None]] = []
        self._has_value = False
        self._value = None
        self._fired = False

    def add_callback(self, cb: Callable[[Any], None]):
        self._callbacks.append(cb)
        if self._has_value and self._fired:
            cb(self._value)

    def add_value(self, value):
        self._has_value = True
        self._value = value

    def fire(self):
        if not self._has_value:
            return
        self._fired = True
        for cb in self._callbacks:
            cb(self._value)
        self._callbacks = []

    @property
    def value(self):
        if not self._has_value:
            raise RuntimeError("lazy value not materialized; call execute() first")
        return self._value


class LazyObjectsManager:
    """Per-session registry of pending LazyEvaluations keyed by (op, tag)."""

    def __init__(self):
        self._lazy: Dict[Any, LazyEvaluation] = {}

    def gen_lazy(self, key) -> LazyEvaluation:
        if key not in self._lazy:
            self._lazy[key] = LazyEvaluation()
        return self._lazy[key]

    def fire_all(self):
        for lazy in list(self._lazy.values()):
            lazy.fire()

    def clear(self):
        self._lazy.clear()


_MANAGER = LazyObjectsManager()


def lazy_objects_manager() -> LazyObjectsManager:
    """The process's manager (the port's operators carry no session id;
    each entry point takes its device explicitly)."""
    return _MANAGER
