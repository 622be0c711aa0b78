"""The port stands alone: ``alink_tpu_torch`` imports neither ``jax`` nor
any module of ``alink_tpu``, and its entry points run on the card unless
the caller asks for the CPU."""

import re
import subprocess
import sys
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parents[1] / "alink_tpu_torch"


def _modules():
    out = []
    for p in sorted(PKG.rglob("*.py")):
        parts = p.relative_to(PKG.parent).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.') or k == 'alink_tpu' or "
        "k.startswith('alink_tpu.'))\n"
        "print(len(sys.modules), bad)\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_source_names_no_jax_import():
    pat = re.compile(r"^\s*(import|from)\s+(jax|alink_tpu)(\.|\s|$)",
                     re.MULTILINE)
    hits = [f"{p.relative_to(PKG.parent)}: {m.group(0).strip()}"
            for p in PKG.rglob("*.py") for m in pat.finditer(p.read_text())]
    assert not hits, hits


def test_entry_points_default_to_the_card(monkeypatch):
    """Without CUDA, an entry point given no device raises; it never
    falls back to the CPU."""
    import torch

    from alink_tpu_torch.common.device import resolve_device
    from alink_tpu_torch.model.interop import linear_model_from_numpy
    from alink_tpu_torch.operator.common.linear.base import \
        LinearModelDataConverter
    from alink_tpu_torch.operator.common.linear.mapper import \
        LinearModelMapper
    from alink_tpu_torch.serving import CompiledPredictor
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    table = LinearModelDataConverter().save_model(linear_model_from_numpy(
        [0.5, 1.0, -1.0], has_intercept=True, label_values=["p", "n"],
        vector_col="vec", vector_size=2))
    mapper = LinearModelMapper(table.schema, None)
    mapper.load_model(table)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        CompiledPredictor(mapper)
    assert resolve_device("cpu") == torch.device("cpu")


def test_hygiene_covers_every_slice_module():
    """The import scans above walk every module of the package; the
    modules of each ported slice are among them."""
    mods = set(_modules())
    for m in ("alink_tpu_torch.kernels.serve",
              "alink_tpu_torch.serving.predictor",
              "alink_tpu_torch.kernels.ftrl",
              "alink_tpu_torch.operator.base",
              "alink_tpu_torch.operator.batch.source.sources",
              "alink_tpu_torch.operator.stream.core",
              "alink_tpu_torch.operator.stream.prefetch",
              "alink_tpu_torch.operator.stream.source.sources",
              "alink_tpu_torch.operator.stream.sink.sinks",
              "alink_tpu_torch.operator.stream.onlinelearning.ftrl",
              "alink_tpu_torch.model.interop",
              "alink_tpu_torch.kernels.tree_hist",
              "alink_tpu_torch.operator.common.tree.hist",
              "alink_tpu_torch.operator.common.tree.trainers",
              "alink_tpu_torch.operator.batch.classification.tree_ops",
              "alink_tpu_torch.engine.comqueue",
              "alink_tpu_torch.engine.communication",
              "alink_tpu_torch.kernels.linear",
              "alink_tpu_torch.ops.fieldblock",
              "alink_tpu_torch.operator.common.optim.objfunc",
              "alink_tpu_torch.operator.common.optim.optimizers",
              "alink_tpu_torch.operator.common.linear.base",
              "alink_tpu_torch.operator.batch.classification.linear",
              "alink_tpu_torch.operator.batch.feature.feature_ops",
              "alink_tpu_torch.operator.common.statistics.summarizer",
              "alink_tpu_torch.operator.batch.dataproc",
              "alink_tpu_torch.operator.batch.dataproc.scalers",
              "alink_tpu_torch.operator.stream.utils",
              "alink_tpu_torch.operator.stream.batch_twins",
              "alink_tpu_torch.operator.stream.dataproc",
              "alink_tpu_torch.operator.stream.dataproc.format",
              "alink_tpu_torch.operator.common.evaluation.metrics",
              "alink_tpu_torch.operator.batch.evaluation.eval_ops",
              "alink_tpu_torch.operator.stream.evaluation",
              "alink_tpu_torch.pipeline.base",
              "alink_tpu_torch.pipeline.feature",
              "alink_tpu_torch.pipeline.classification",
              "alink_tpu_torch.native",
              "alink_tpu_torch.io.csv",
              "alink_tpu_torch.io.sharding",
              "alink_tpu_torch.io.fieldblock",
              "alink_tpu_torch.operator.batch.sink.sinks",
              "alink_tpu_torch.operator.common.dataproc.feature_extract",
              "alink_tpu_torch.operator.common.linear.mapper",
              "alink_tpu_torch.operator.batch.regression",
              "alink_tpu_torch.operator.batch.regression.linear",
              "alink_tpu_torch.operator.common.clustering",
              "alink_tpu_torch.operator.common.clustering.kmeans",
              "alink_tpu_torch.operator.batch.clustering",
              "alink_tpu_torch.operator.batch.clustering.kmeans_ops",
              "alink_tpu_torch.pipeline.regression",
              "alink_tpu_torch.pipeline.clustering",
              "alink_tpu_torch.ops.smallsolve",
              "alink_tpu_torch.operator.common.recommendation.als",
              "alink_tpu_torch.operator.batch.recommendation",
              "alink_tpu_torch.operator.batch.recommendation.als_ops",
              "alink_tpu_torch.operator.stream.recommendation",
              "alink_tpu_torch.operator.stream.predict_ops",
              "alink_tpu_torch.operator.batch.evaluation",
              "alink_tpu_torch.pipeline.extras",
              "alink_tpu_torch.pipeline.tree",
              "alink_tpu_torch.common.flags",
              "alink_tpu_torch.common.metrics",
              "alink_tpu_torch.common.tracing",
              "alink_tpu_torch.common.reqtrace",
              "alink_tpu_torch.common.postmortem",
              "alink_tpu_torch.common.adminz",
              "alink_tpu_torch.common.profiling2",
              "alink_tpu_torch.serving.loadgen",
              "alink_tpu_torch.serving.resilience",
              "alink_tpu_torch.serving.plan",
              "alink_tpu_torch.serving.server",
              "alink_tpu_torch.serving",
              "alink_tpu_torch.operator.stream.utils"):
        assert m in mods, m
    for src in ("serve_score.cu", "ftrl_state.cu", "tree_hist.cu",
                "linear_grad.cu", "run_plan.cu"):
        assert (PKG / "kernels" / "csrc" / src).exists(), src
    assert (PKG / "native" / "csrc" / "parser.cpp").exists()


def test_native_library_is_the_ports_own_build():
    """The port's native library loads from ``build/`` at the root of the
    checkout, under the hash of ``alink_tpu_torch/native/csrc/parser.cpp``
    and its flags; no file under ``alink_tpu/`` is read or mapped."""
    code = (
        "import hashlib, sys\n"
        "from pathlib import Path\n"
        "import alink_tpu_torch.native as n\n"
        "root = Path.cwd().resolve()\n"
        "assert n.SRC == root / 'alink_tpu_torch/native/csrc/parser.cpp'\n"
        "assert n.BUILD_DIR == root / 'build'\n"
        "h = hashlib.sha256(' '.join(n.FLAGS).encode())\n"
        "h.update(n.SRC.read_bytes())\n"
        "lib = root / 'build' / f'libparser-{h.hexdigest()[:16]}.so'\n"
        "assert n.target() == lib, (n.target(), lib)\n"
        "n.murmur32_batch([b'a'])\n"
        "maps = open('/proc/self/maps').read()\n"
        "assert str(lib) in maps, 'the port library is not mapped'\n"
        "assert '_parser.native' not in maps and 'alink_tpu/native' "
        "not in maps, 'a JAX-package library is mapped'\n"
        "assert not [k for k in sys.modules if k == 'alink_tpu' or "
        "k.startswith('alink_tpu.')]\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_chip_smoke_names_no_jax():
    """``chip_smoke.py`` imports neither ``jax`` nor ``alink_tpu``."""
    src = (PKG.parent / "chip_smoke.py").read_text()
    pat = re.compile(r"^\s*(import|from)\s+(jax|alink_tpu)(\.|\s|$)",
                     re.MULTILINE)
    assert not pat.findall(src)


def test_kernel_ab_names_no_jax():
    """``kernel_ab.py`` (old against new on the card) imports neither
    ``jax`` nor ``alink_tpu``."""
    src = (PKG.parent / "kernel_ab.py").read_text()
    pat = re.compile(r"^\s*(import|from)\s+(jax|alink_tpu)(\.|\s|$)",
                     re.MULTILINE)
    assert not pat.findall(src)


def test_feature_hasher_loads_no_jax_library():
    """Hashing a batch (flat and field-aware) and hashing to fields load
    no shared library of the JAX package (its native parser) and import
    neither ``jax`` nor ``alink_tpu``."""
    code = (
        "import sys, numpy as np\n"
        "from alink_tpu_torch.common.mtable import MTable\n"
        "from alink_tpu_torch.operator.base import TableSourceBatchOp\n"
        "from alink_tpu_torch.operator.batch.feature.feature_ops import "
        "FeatureHasherBatchOp, murmur32_cells\n"
        "from alink_tpu_torch.ops.fieldblock import hash_to_fields\n"
        "t = MTable({'s': np.array(['a', 'b', None], object), "
        "'x': np.array([1.0, 2.0, 3.0])}, 's STRING, x DOUBLE')\n"
        "for fa in (False, True):\n"
        "    FeatureHasherBatchOp(selected_cols=['s', 'x'], "
        "num_features=64, field_aware=fa).link_from(TableSourceBatchOp(t))\n"
        "murmur32_cells([b'a', b'bc'], mod=7)\n"
        "hash_to_fields([[1, 2], ['a', 'b']], 16)\n"
        "maps = open('/proc/self/maps').read()\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.') or k == 'alink_tpu' or "
        "k.startswith('alink_tpu.'))\n"
        "assert '_parser.native' not in maps and 'alink_tpu/native' "
        "not in maps, 'a JAX-package library is mapped'\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def _lr_table():
    import numpy as np

    from alink_tpu_torch.common.mtable import MTable
    rng = np.random.RandomState(0)
    x = rng.randn(40)
    return MTable({"x": x, "y": (x + 0.3 * rng.randn(40) > 0).astype(int)},
                  "x DOUBLE, y LONG")


def test_estimators_default_to_the_card(monkeypatch):
    """A ``LogisticRegression`` estimator, alone or in a ``Pipeline``,
    given no device raises without CUDA (the train op resolves
    ``cuda``); given ``device="cpu"`` (its own, or the pipeline's) it
    trains on the CPU. The device is not a param and is not saved."""
    import torch

    from alink_tpu_torch.operator.batch.source import MemSourceBatchOp
    from alink_tpu_torch.pipeline import Pipeline
    from alink_tpu_torch.pipeline.classification import LogisticRegression
    from alink_tpu_torch.pipeline.feature import StandardScaler
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = MemSourceBatchOp(_lr_table())
    kw = dict(feature_cols=["x"], label_col="y", prediction_col="p",
              max_iter=3)
    with pytest.raises(RuntimeError, match="CUDA"):
        Pipeline(StandardScaler(selected_cols=["x"]),
                 LogisticRegression(**kw)).fit(data)
    with pytest.raises(RuntimeError, match="CUDA"):
        LogisticRegression(**kw).fit(data)
    stage = LogisticRegression(**kw)
    for model in (
            Pipeline(StandardScaler(selected_cols=["x"]), stage,
                     device="cpu").fit(data),
            Pipeline(StandardScaler(selected_cols=["x"]),
                     LogisticRegression(device="cpu", **kw)).fit(data),
            LogisticRegression(device="cpu", **kw).fit(data)):
        out = model.transform(data).get_output_table()
        assert out.num_rows == 40 and "p" in out.col_names
    assert stage.device is None                   # the caller's stage
    assert stage.clone().device is None
    assert LogisticRegression(device="cpu", **kw).clone().device == "cpu"
    assert "device" not in LogisticRegression(device="cpu", **kw) \
        .params.to_json()


@pytest.mark.parametrize("name", [
    "classification.LinearSvmTrainBatchOp",
    "classification.SoftmaxTrainBatchOp",
    "classification.PerceptronTrainBatchOp",
    "regression.LinearRegTrainBatchOp", "regression.RidgeRegTrainBatchOp",
    "regression.LassoRegTrainBatchOp", "regression.LinearSvrTrainBatchOp",
    "clustering.KMeansTrainBatchOp", "clustering.KMeansPredictBatchOp"])
def test_slice_13_ops_default_to_the_card(monkeypatch, name):
    """The train ops of slice 13 (and the KMeans predict op) given no
    device raise without CUDA; given ``device="cpu"`` they take it."""
    import importlib

    import torch
    pkg, cls = name.split(".")
    op = getattr(importlib.import_module(
        f"alink_tpu_torch.operator.batch.{pkg}"), cls)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        op()
    assert op(device="cpu").device == torch.device("cpu")
