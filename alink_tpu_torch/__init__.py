"""alink_tpu_torch — the PyTorch / CUDA port of ``alink_tpu`` for one
NVIDIA H100.

The package mirrors ``alink_tpu``'s layout module for module; each
module's docstring names its counterpart there. It imports ``torch``
and numpy and never ``jax`` or any module of ``alink_tpu``. Entry points
that do device work run on ``cuda`` unless the caller asks for the CPU
(``device="cpu"``), and raise without a card.

Slices of the port, in order: the serving path of a binary linear model
(``serving``, the kernels of ``kernels/serve.py``); sparse online FTRL
(``operator.stream.onlinelearning``, ``kernels/ftrl.py``); tree learning
on the one-worker BSP engine (``engine``, ``kernels/tree_hist.py``);
batch logistic regression and its optimizers (``operator/common/optim``,
``kernels/linear.py``); the FTRLExample loop (``pipeline``, the stream
runtime); the rest of the linear family and KMeans; checkpoints; ALS,
the evaluation and the stream predict twins; the serving tier and the
observability planes; training health and the online DAG
(``online``); FM, LDA, Word2Vec and the text front end
(``kernels/rows.py``, ``kernels/fm.py``); the tuning layer
(``tuning``); the remaining model families; feature engineering,
statistics, similarity and outlier detection; and SQL, the format
matrix, UDFs, lazy evaluation, association rules and the connectors
(``io``: databases, Hive, Kafka, DirectReader, bucketing).

Flat namespace (the JAX package's, the PyAlink idiom of README.md's
``from pyalink.alink import *``): every operator and pipeline stage of
``operator.batch``, ``operator.stream``, ``pipeline`` and ``io`` is
importable from this package, with the common and engine names below.
It resolves lazily (PEP 562): ``import alink_tpu_torch`` imports none of
those modules, and the first name asked for walks them all once. An
import error there propagates: no module is skipped, since none of them
imports an optional driver at import time (MySQL, Hive and Kafka clients
are imported when a connection is made).
"""

__version__ = "0.1.0"

# names of the JAX package's top level, from the port's modules
_TOP = {
    "common.params": ("Params", "ParamInfo", "WithParams"),
    "common.types": ("AlinkTypes", "TableSchema"),
    "common.vector": ("DenseVector", "SparseVector", "VectorUtil",
                      "SparseBatch", "DenseMatrix"),
    "common.mtable": ("MTable",),
    "common.mlenv": ("MLEnvironment", "MLEnvironmentFactory",
                     "use_local_env", "use_remote_env"),
    "common.lazy": ("LazyEvaluation", "LazyObjectsManager"),
    "common.metrics": ("MetricsRegistry", "get_registry", "set_registry",
                       "metrics_enabled"),
    "common.tracing": ("Tracer", "get_tracer", "set_tracer",
                       "tracing_enabled", "trace_span", "trace_instant"),
    "common.health": ("HealthAlert", "HealthAlertError", "HealthMonitor",
                      "HealthRule", "NonFiniteRule", "DivergenceRule",
                      "PlateauRule", "ThresholdRule", "UpdateRatioRule",
                      "DriftRule", "default_rules", "health_enabled"),
    "engine": ("IterativeComQueue", "ComContext", "ComputeFunction",
               "AllReduce", "AllGather", "BroadcastFromWorker0"),
}
_SUBPACKAGES = ("common", "engine", "io", "kernels", "mapper", "model",
                "native", "online", "operator", "ops", "params", "pipeline",
                "serving", "tuning")
_EXPORT_ROOTS = ("alink_tpu_torch.operator.batch",
                 "alink_tpu_torch.operator.stream",
                 "alink_tpu_torch.pipeline", "alink_tpu_torch.io")
_exports = None


def _collect_exports():
    """name -> class over every module under the export roots (the
    first module, in walk order, that holds a name wins, as in the JAX
    package)."""
    import importlib
    import pkgutil
    mapping = {}
    for root in _EXPORT_ROOTS:
        pkg = importlib.import_module(root)
        mods = [root] + [m.name for m in
                         pkgutil.walk_packages(pkg.__path__, root + ".")]
        for name in mods:
            mod = importlib.import_module(name)
            for nm, obj in vars(mod).items():
                if (nm[:1].isupper() and isinstance(obj, type) and
                        getattr(obj, "__module__", "").startswith(
                            "alink_tpu_torch")):
                    mapping.setdefault(nm, obj)
    return mapping


def _top_name(name):
    import importlib
    for mod, names in _TOP.items():
        if name in names:
            return getattr(importlib.import_module(
                f"{__name__}.{mod}"), name)
    if name in _SUBPACKAGES:
        return importlib.import_module(f"{__name__}.{name}")
    raise KeyError(name)


def __getattr__(name):
    global _exports
    if name == "__all__":
        # star-import support: ``from alink_tpu_torch import *`` reads
        # __all__ (PEP 562's __getattr__ is reached for it)
        if _exports is None:
            _exports = _collect_exports()
        return sorted(set(_exports) | {n for names in _TOP.values()
                                       for n in names})
    if name.startswith("_"):
        raise AttributeError(name)
    try:
        obj = _top_name(name)
    except KeyError:
        if _exports is None:
            _exports = _collect_exports()
        try:
            obj = _exports[name]
        except KeyError:
            raise AttributeError(
                f"module {__name__!r} has no attribute {name!r}") from None
    globals()[name] = obj  # cache for later lookups
    return obj


def __dir__():
    global _exports
    if _exports is None:
        _exports = _collect_exports()
    return sorted(set(globals()) | set(_exports) | set(_SUBPACKAGES)
                  | {n for names in _TOP.values() for n in names})
