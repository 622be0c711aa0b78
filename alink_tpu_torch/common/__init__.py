"""Host data layer of the port (counterpart: ``alink_tpu/common``).

Exported here as there: the params, types, vectors, ``MTable``, the
session layer (``MLEnvironment``, ``MLEnvironmentFactory``,
``use_local_env``, ``use_remote_env``) and the lazy-evaluation classes.
The JAX package's exports of its profiling module (``StepTimer``,
``named_stage``, ``trace``) wait for that module (ROADMAP A10(b)); the
metrics, tracing and health names are exported by the package's flat
namespace (``alink_tpu_torch/__init__.py``)."""

from .lazy import LazyEvaluation, LazyObjectsManager, lazy_objects_manager
from .mlenv import (MLEnvironment, MLEnvironmentFactory, use_local_env,
                    use_remote_env)
from .mtable import MTable
from .params import InValidator, MinValidator, ParamInfo, Params, RangeValidator, WithParams
from .types import AlinkTypes, TableSchema
from .vector import DenseMatrix, DenseVector, SparseBatch, SparseVector, Vector, VectorUtil
