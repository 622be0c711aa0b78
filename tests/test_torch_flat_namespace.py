"""Slice 25 of the port: the flat namespace of ``alink_tpu_torch`` (the
JAX package's PEP 562 export surface, the PyAlink ``from pyalink.alink
import *`` contract).

* Every name of the reference inventory (``tests/test_flat_namespace.py::
  REFERENCE_INVENTORY``, 224 names) resolves, to a class of the port.
* Every public name of the JAX package's flat surface (``dir(alink_tpu)``)
  resolves in the port, except the names that the JAX package's modules
  still without a port file define (listed below), and to the same
  object as there: the same ``__name__`` and the same module, with
  ``alink_tpu_torch`` in place of ``alink_tpu`` (a shadowing alias or
  another op of the same name would differ). No name is an intended
  difference.
* ``import alink_tpu_torch`` imports no operator module and no jax; the
  first name asked for walks the export roots once.
* An import error in an exported module propagates (nothing is skipped).
"""

import subprocess
import sys
import types
from pathlib import Path

import pytest

import alink_tpu
import alink_tpu_torch
from test_flat_namespace import REFERENCE_INVENTORY

ROOT = Path(__file__).resolve().parents[1]
# the JAX package's modules with no port file (ROADMAP A9, A10(b) and
# the two kept out on purpose)
UNPORTED_MODULES = ("alink_tpu.aotcache", "alink_tpu.compileledger",
                    "alink_tpu.plan", "alink_tpu.common.profiling",
                    "alink_tpu.kernels.runtime", "alink_tpu.common.compat",
                    "alink_tpu.serving.fleet")
UNPORTED_NAMES = {"StepTimer", "named_stage", "trace"}
# names whose port object is meant to differ from the JAX package's
INTENDED_DIFFERENCES = set()


def _identity(obj, package):
    """(name, module) of a flat name's object, ``package`` mapped to
    ``alink_tpu``: a module's own dotted name twice, else the object's
    ``__name__`` (its type's for an instance) and ``__module__``."""
    def mapped(dotted):
        if dotted == package or dotted.startswith(package + "."):
            return "alink_tpu" + dotted[len(package):]
        return dotted
    if isinstance(obj, types.ModuleType):
        return mapped(obj.__name__), mapped(obj.__name__)
    named = obj if hasattr(obj, "__name__") else type(obj)
    return named.__name__, mapped(named.__module__)


def test_reference_inventory_resolves_to_port_classes():
    assert len(REFERENCE_INVENTORY) == 224
    for name in REFERENCE_INVENTORY:
        obj = getattr(alink_tpu_torch, name)
        assert isinstance(obj, type), name
        assert obj.__module__.startswith("alink_tpu_torch."), name
        assert _identity(obj, "alink_tpu_torch") == _identity(
            getattr(alink_tpu, name), "alink_tpu"), name


def test_the_jax_packages_flat_surface_resolves():
    public = sorted(n for n in dir(alink_tpu) if not n.startswith("_"))
    missing = [n for n in public if not hasattr(alink_tpu_torch, n)]
    assert set(missing) == UNPORTED_NAMES, missing
    for n in UNPORTED_NAMES:
        assert getattr(alink_tpu, n).__module__ in UNPORTED_MODULES
    differ = []
    for n in public:
        if n in UNPORTED_NAMES:
            continue
        obj = getattr(alink_tpu_torch, n)
        mod = getattr(obj, "__module__", None) or obj.__name__
        assert mod.startswith("alink_tpu_torch"), (n, mod)
        got = _identity(obj, "alink_tpu_torch")
        want = _identity(getattr(alink_tpu, n), "alink_tpu")
        if got != want:
            differ.append((n, got, want))
    assert {d[0] for d in differ} == INTENDED_DIFFERENCES, differ


def test_star_import_and_dir():
    ns = {}
    exec("from alink_tpu_torch import *", ns)
    for n in ("KMeansTrainBatchOp", "Pipeline", "FtrlTrainStreamOp",
              "SelectBatchOp", "KvToVectorBatchOp", "HiveSourceBatchOp",
              "KafkaSourceStreamOp", "FpGrowthBatchOp", "UDFStreamOp",
              "MLEnvironment", "HealthMonitor"):
        assert n in ns, n
    d = dir(alink_tpu_torch)
    assert "TableBucketingSink" in d and "DirectReader" in d


def test_import_is_cheap_and_loads_no_jax():
    code = ("import sys, alink_tpu_torch\n"
            "ops = [k for k in sys.modules if k.startswith("
            "'alink_tpu_torch.operator') or k.startswith('alink_tpu_torch.io')"
            " or k.startswith('alink_tpu_torch.pipeline')]\n"
            "assert not ops, ops\n"
            "cls = alink_tpu_torch.SelectBatchOp\n"
            "assert cls.__module__ == 'alink_tpu_torch.operator.batch.sql'\n"
            "bad = [k for k in sys.modules if k == 'jax' or "
            "k.startswith('jax.') or k == 'alink_tpu' or "
            "k.startswith('alink_tpu.')]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_an_import_error_propagates(tmp_path, monkeypatch):
    pkg = tmp_path / "brokenroot"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    (pkg / "good.py").write_text("class GoodOp:\n    pass\n")
    (pkg / "bad.py").write_text("import no_such_module_anywhere\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.setattr(alink_tpu_torch, "_EXPORT_ROOTS", ("brokenroot",))
    with pytest.raises(ModuleNotFoundError, match="no_such_module"):
        alink_tpu_torch._collect_exports()
