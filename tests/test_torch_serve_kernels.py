"""The port's serving score functions against the JAX package's.

``alink_tpu_torch/kernels/serve.py`` holds the fused dense and sparse
score kernels (CUDA) beside their plain PyTorch versions. On the CPU the
wrappers run the plain versions, and those are held here, BITWISE,
against the JAX package's fused Pallas kernels (in interpret mode, as
tests/test_kernels.py runs them) and its XLA score functions, on the
same seeded inputs: every mode (f32, bf16, int8), dense and sparse, at
float32 and float64 ship dtypes. The CUDA kernels themselves are held
against the plain versions on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from alink_tpu_torch.kernels import serve as tserve


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int64) if a.dtype == np.float64 else a.view(np.int32)


def _ulps(a, b):
    """Largest distance in units in the last place between two float
    arrays of one dtype (through the sign-magnitude integer order)."""
    def order(x):
        i = _bits(x).astype(np.int64)
        top = np.int64(0x7FFFFFFFFFFFFFFF) if x.dtype == np.float64 \
            else np.int64(0x7FFFFFFF)
        return np.where(i < 0, -(i & top), i)
    return int(np.abs(order(np.asarray(a)) - order(np.asarray(b))).max())


def _inputs(seed, ship, dim8, n, width):
    rng = np.random.RandomState(seed)
    w = rng.randn(dim8).astype(ship)
    b = ship(rng.randn())
    X = rng.randn(n, dim8).astype(ship)
    idx = rng.randint(0, dim8, (n, width)).astype(np.int32)
    val = rng.randn(n, width).astype(ship)
    return w, b, X, idx, val


def _jax_model(w, b, dtype):
    from alink_tpu.kernels.serve import lowp_model_arrays
    if dtype == "f32":
        return (w, np.asarray(b, w.dtype))
    return lowp_model_arrays(w, b, dtype)


def _port_model(w, b, dtype):
    if dtype == "f32":
        return (torch.from_numpy(w), torch.tensor(b))
    return tserve.lowp_model_arrays(w, b, dtype)


# (ship dtype, dim8, rows): dim8 128 reduces through the JAX package's
# unrolled chain, 256 through its chunked scan. Sparse widths 8 and 16.
CASES = [(np.float32, 128, 64), (np.float64, 256, 37)]

# The one place the port cannot be bitwise: at a sparse width of exactly
# 8, XLA's CPU backend contracts the JAX package's term multiplies into
# the add chain (FMA), against that package's own no-FMA contract, in
# the fused (interpret) and XLA functions alike. bf16 terms are exact
# products, so contraction changes nothing there. The port keeps the
# contract. Measured gap on these fixtures, in units in the last place
# of the score (ROADMAP.md Queue C): {(ship, mode): max ulps}. The ulps
# grow where a row's terms cancel; against the terms' magnitude the gap
# stays within 1.1 * eps * sum|terms|.
WIDTH8_ULP_GAP = {(np.float32, "f32"): 12, (np.float32, "int8"): 41,
                  (np.float64, "f32"): 256, (np.float64, "int8"): 11}


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("ship,dim8,n", CASES)
def test_plain_versions_bitwise_vs_jax(monkeypatch, dtype, ship, dim8, n):
    import jax
    import jax.numpy as jnp
    from alink_tpu.kernels.serve import (make_fused_score_fns,
                                         make_xla_score_fns)
    monkeypatch.setenv("ALINK_TPU_PALLAS_INTERPRET", "1")
    runs = [("dense", 8)] + [("sparse", width) for width in (8, 16)]
    for kind, width in runs:
        w, b, X, idx, val = _inputs(dim8 + n + width, ship, dim8, n, width)
        jmdl = tuple(jnp.asarray(a) for a in _jax_model(w, b, dtype))
        pmdl = _port_model(w, b, dtype)
        if kind == "dense":
            got = tserve.dense_scores(pmdl, torch.from_numpy(X), dtype)
            args = (jnp.asarray(X),)
        else:
            got = tserve.sparse_scores(pmdl, torch.from_numpy(idx),
                                       torch.from_numpy(val), dtype)
            args = (jnp.asarray(idx), jnp.asarray(val))
        got = got.numpy()
        assert got.dtype == (ship if dtype == "f32" else np.float32)
        for make in (make_fused_score_fns, make_xla_score_fns):
            want = np.asarray(jax.jit(make(dtype, ship)[kind])(jmdl, *args))
            where = (kind, width, make.__name__)
            assert want.dtype == got.dtype, where
            gap = WIDTH8_ULP_GAP.get((ship, dtype)) \
                if (kind, width) == ("sparse", 8) else None
            if gap is None:
                assert np.array_equal(_bits(got), _bits(want)), where
            else:
                assert _ulps(got, want) <= gap, where


def _round_f32(x):
    """The exact rational ``x`` rounded once to float32 (ties to even)."""
    from fractions import Fraction
    r = np.float32(float(x))
    cands = [np.nextafter(r, np.float32(-np.inf)), r,
             np.nextafter(r, np.float32(np.inf))]
    errs = [abs(Fraction(float(c)) - x) for c in cands]
    best = min(errs)
    ties = [c for c, e in zip(cands, errs) if e == best]
    return min(ties, key=lambda c: int(np.asarray(c).view(np.int32)) & 1)


def test_int8_epilogue_is_one_rounding():
    """The int8 epilogue rounds ``acc * scale + b`` ONCE, as an FMA
    does, also where a float64 sum rounded again to float32 would not."""
    from fractions import Fraction
    rng = np.random.RandomState(7)
    acc = (rng.randn(2048) * 100).astype(np.float32)
    scale, b = np.float32(0.0123), np.float32(0.377)
    got = tserve._fma_f32(torch.from_numpy(acc), torch.tensor([scale]),
                          torch.tensor(b)).numpy()
    want = np.asarray([_round_f32(Fraction(float(a)) * Fraction(float(scale))
                                  + Fraction(float(b))) for a in acc])
    two = (acc * scale).astype(np.float32) + b
    assert (two != want).any()          # the fixture tells them apart
    assert np.array_equal(_bits(got), _bits(want))


def test_padding_is_a_noop():
    """Zero rows and zero columns appended to a request leave the real
    rows' scores bitwise unchanged — what makes buckets no-ops."""
    w, b, X, idx, val = _inputs(3, np.float32, 128, 10, 8)
    for dtype in ("f32", "bf16", "int8"):
        mdl = _port_model(w, b, dtype)
        base = tserve.dense_scores(mdl, torch.from_numpy(X), dtype)
        Xp = np.zeros((32, 128), np.float32)
        Xp[:10] = X
        padded = tserve.dense_scores(mdl, torch.from_numpy(Xp), dtype)[:10]
        assert np.array_equal(_bits(base.numpy()), _bits(padded.numpy()))
        s0 = tserve.sparse_scores(mdl, torch.from_numpy(idx),
                                  torch.from_numpy(val), dtype)
        idxp = np.zeros((16, 16), np.int32)
        valp = np.zeros((16, 16), np.float32)
        idxp[:10, :8], valp[:10, :8] = idx, val
        s1 = tserve.sparse_scores(mdl, torch.from_numpy(idxp),
                                  torch.from_numpy(valp), dtype)[:10]
        assert np.array_equal(_bits(s0.numpy()), _bits(s1.numpy()))


def test_wrapper_never_falls_back():
    """Off the CPU the wrapper launches its kernel or raises: a tensor
    on a device that is neither CPU nor CUDA is refused, and the kernel
    build raises where there is no nvcc (never a silent plain path)."""
    mdl = (torch.zeros(64, device="meta"), torch.zeros((), device="meta"))
    with pytest.raises(ValueError):
        tserve.dense_scores(mdl, torch.zeros((4, 64), device="meta"), "f32")
    with pytest.raises(ValueError):
        tserve.sparse_scores(mdl, torch.zeros((4, 8), dtype=torch.int32,
                                              device="meta"),
                             torch.zeros((4, 8), device="meta"), "f32")
    assert tserve.launch_counts() == {"serve_dense": 0, "serve_sparse": 0}


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    from alink_tpu_torch.kernels import _build
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build(["serve_score"])


def test_quantize_and_lowp_arrays_match_jax():
    from alink_tpu.kernels.serve import lowp_model_arrays, quantize_int8
    rng = np.random.RandomState(1)
    w = rng.randn(256)
    q, s = tserve.quantize_int8(w)
    jq, js = quantize_int8(w)
    assert np.array_equal(q, jq) and s == js
    for dtype in ("bf16", "int8"):
        mine = tserve.lowp_model_arrays(w, 0.3, dtype)
        ref = lowp_model_arrays(w, 0.3, dtype)
        for a, r in zip(mine, ref):
            a = a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 \
                else a.numpy()
            r = np.asarray(r)
            r = r.view(np.int16) if a.dtype == np.int16 else r
            assert a.shape == r.shape and np.array_equal(a, r)
