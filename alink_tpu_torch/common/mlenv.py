"""Session / environment layer at one worker.

Counterpart: ``alink_tpu/common/mlenv.py``. There a session holds a
``jax.sharding.Mesh`` whose data axis is the worker count. Here a
session holds one ``torch.device``, resolved once by
:func:`~alink_tpu_torch.common.device.resolve_device` (``cuda`` unless
the caller asks for the CPU), and runs one worker: ``num_workers`` is 1.
Asking for ``parallelism > 1`` raises ``NotImplementedError``: several
cards wait for the multi-GPU slice (ROADMAP A9), and so does a
``use_remote_env`` of more than one process (of one, it is
``use_local_env``). The lazy-objects manager is not on the session: it
lives in ``common/lazy.py`` (``lazy_objects_manager``), so that reaching
it resolves no device. Not ported: the model axis and the mesh-size
flags.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

import torch

from .device import resolve_device


class MLEnvironment:
    """One session: the device every engine program of it runs on."""

    def __init__(self, parallelism: Optional[int] = None, device=None):
        if parallelism not in (None, 1):
            raise NotImplementedError(
                f"parallelism={parallelism}: the port runs one worker on "
                f"one device; several cards wait for the multi-GPU slice")
        self.device: torch.device = resolve_device(device)

    @property
    def num_workers(self) -> int:
        """Flink parallelism analogue: always 1 here."""
        return 1


class MLEnvironmentFactory:
    """id -> MLEnvironment registry (reference MLEnvironmentFactory.java:42-90)."""

    DEFAULT_ML_ENVIRONMENT_ID = 0
    _lock = threading.Lock()
    _map: Dict[int, MLEnvironment] = {}
    _next_id = 1

    @classmethod
    def get(cls, session_id: int) -> MLEnvironment:
        with cls._lock:
            if session_id not in cls._map:
                if session_id == cls.DEFAULT_ML_ENVIRONMENT_ID:
                    cls._map[session_id] = MLEnvironment()
                else:
                    raise KeyError(
                        f"Cannot find MLEnvironment for id {session_id}; "
                        "call get_new_ml_environment_id()/set_default first.")
            return cls._map[session_id]

    @classmethod
    def get_default(cls) -> MLEnvironment:
        return cls.get(cls.DEFAULT_ML_ENVIRONMENT_ID)

    @classmethod
    def set_default(cls, env: MLEnvironment):
        with cls._lock:
            cls._map[cls.DEFAULT_ML_ENVIRONMENT_ID] = env

    @classmethod
    def get_new_ml_environment_id(cls) -> int:
        with cls._lock:
            sid = cls._next_id
            cls._next_id += 1
            cls._map[sid] = MLEnvironment()
            return sid

    @classmethod
    def register(cls, env: MLEnvironment) -> int:
        with cls._lock:
            sid = cls._next_id
            cls._next_id += 1
            cls._map[sid] = env
            return sid

    @classmethod
    def remove(cls, session_id: int) -> Optional[MLEnvironment]:
        with cls._lock:
            if session_id == cls.DEFAULT_ML_ENVIRONMENT_ID:
                return cls._map.get(session_id)
            return cls._map.pop(session_id, None)

    @classmethod
    def reset(cls):
        with cls._lock:
            cls._map.clear()
            cls._next_id = 1


def use_local_env(parallelism: Optional[int] = None,
                  device=None) -> MLEnvironment:
    """PyAlink-style entry (reference README.md:49-58 ``useLocalEnv``):
    a one-worker session on ``device`` becomes the default."""
    env = MLEnvironment(parallelism=parallelism, device=device)
    MLEnvironmentFactory.set_default(env)
    return env


def use_remote_env(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   parallelism: Optional[int] = None,
                   device=None) -> MLEnvironment:
    """Multi-host entry (reference ``useRemoteEnv``). The port runs one
    process: ``num_processes`` above 1 raises ``NotImplementedError``
    (several processes wait for the multi-GPU slice); otherwise this is
    :func:`use_local_env` (the coordinator address and process id of a
    one-process job name nothing to join)."""
    if num_processes is not None and num_processes > 1:
        raise NotImplementedError(
            f"use_remote_env(num_processes={num_processes}): the port runs "
            f"one process; several wait for the multi-GPU slice")
    return use_local_env(parallelism=parallelism, device=device)
