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
              "alink_tpu_torch.model.interop"):
        assert m in mods, m
    assert (PKG / "kernels" / "csrc" / "ftrl_state.cu").exists()


def test_chip_smoke_names_no_jax():
    """``chip_smoke.py`` imports neither ``jax`` nor ``alink_tpu``."""
    src = (PKG.parent / "chip_smoke.py").read_text()
    pat = re.compile(r"^\s*(import|from)\s+(jax|alink_tpu)(\.|\s|$)",
                     re.MULTILINE)
    assert not pat.findall(src)
