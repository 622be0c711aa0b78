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


# (rows, dim8): a single row, a few rows, a bucket and one row past it,
# dim8 on both sides of the JAX package's unrolled chain (<= 128) and its
# chunked scan, up to the dense path's 1024
DENSE_SHAPES = [(1, 16), (1, 136), (7, 64), (33, 264), (513, 72),
                (2, 1024)]


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("ship", [np.float32, np.float64])
@pytest.mark.parametrize("n,dim8", DENSE_SHAPES)
def test_dense_plain_bitwise_vs_jax_shapes(monkeypatch, n, dim8, ship,
                                           dtype):
    """The dense plain version (what the kernel is held to on the card)
    bitwise against the JAX package's fused dense kernel (interpret
    mode) at the row counts and widths the one-warp-per-row design
    splits differently."""
    import jax
    import jax.numpy as jnp
    from alink_tpu.kernels.serve import make_fused_score_fns
    monkeypatch.setenv("ALINK_TPU_PALLAS_INTERPRET", "1")
    w, b, X, _, _ = _inputs(n * 7 + dim8, ship, dim8, n, 8)
    jmdl = tuple(jnp.asarray(a) for a in _jax_model(w, b, dtype))
    got = tserve.dense_scores(_port_model(w, b, dtype), torch.from_numpy(X),
                              dtype).numpy()
    want = np.asarray(jax.jit(make_fused_score_fns(dtype, ship)["dense"])(
        jmdl, jnp.asarray(X)))
    assert got.dtype == want.dtype and got.shape == (n,)
    assert np.array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("itemsize", [2, 4, 8])
@pytest.mark.parametrize("n", [1, 7, 33, 131, 132, 263, 512, 513, 4096])
@pytest.mark.parametrize("dim", [8, 1024, 1031, 65536])
def test_dense_plan_covers_every_row_once(n, dim, itemsize):
    """The dense kernel's launch shape: a block per SM at least where
    there are rows for it, each row in exactly one (block, warp), a last
    block of 1 to ``rows`` rows, and chunks of whole 32-term steps (whole
    16-byte words) within the kernel's 2 KB a row."""
    sms = tserve.H100_SMS
    plan = tserve._dense_plan(n, dim, itemsize, sms)
    assert 1 <= plan.rows <= 4
    blocks = -(-n // plan.rows)                  # the kernel's grid
    assert blocks >= min(n, sms)
    covered = [blk * plan.rows + warp for blk in range(blocks)
               for warp in range(plan.rows) if blk * plan.rows + warp < n]
    assert covered == list(range(n))
    assert 1 <= n - (blocks - 1) * plan.rows <= plan.rows
    assert plan.chunk % 32 == 0 and (plan.chunk * itemsize) % 16 == 0
    assert 32 <= plan.chunk and plan.chunk * itemsize <= 2048
    assert plan.chunk <= -(-dim // 32) * 32
    if n == 1:
        assert plan.rows == 1 and blocks == 1
    if n == 512:                       # the top bucket: every SM busy
        assert plan.rows == 3 and blocks == 171


@pytest.mark.parametrize("bad", [(0, 64, 4), (4, 0, 4), (4, 64, 3),
                                 (4, 64, 16)])
def test_dense_plan_refuses_what_the_kernel_does_not_take(bad):
    with pytest.raises(ValueError):
        tserve._dense_plan(*bad)


@pytest.mark.parametrize("n", [1, 3, 7, 131, 132, 263, 512, 513, 4096,
                               100_000])
@pytest.mark.parametrize("width", [0, 8, 40, 256, 1031])
def test_sparse_plan_covers_every_row_once(n, width):
    """The sparse kernel's launch shape: a block per SM at least where
    there are rows for it (171 blocks of 3 one-row warps at the 512-row
    bucket, one block at 1 row), each row in exactly one (block, warp,
    lane), whole 32-term passes of at most 256 terms, and shared memory
    (a pass of float64 terms a warp) under the 48 KB a launch takes
    without opting in."""
    sms = tserve.H100_SMS
    plan = tserve._sparse_plan(n, width, sms)
    assert 1 <= plan.rows <= 32 and 1 <= plan.warps <= 4
    per_block = plan.rows * plan.warps
    blocks = -(-n // per_block)                  # the kernel's grid
    assert blocks >= min(n, sms)
    covered = [(blk * plan.warps + warp) * plan.rows + lane
               for blk in range(blocks) for warp in range(plan.warps)
               for lane in range(plan.rows)]
    assert sorted(r for r in covered if r < n) == list(range(n))
    assert plan.chunk % 32 == 0 and 32 <= plan.chunk <= 256
    assert plan.chunk <= max(32, -(-plan.rows * width // 32) * 32)
    assert plan.warps * plan.chunk * 8 < 48 * 1024
    if n == 1:
        assert (plan.rows, plan.warps) == (1, 1) and blocks == 1
    if n == 512:                       # the top bucket: every SM busy
        assert (plan.rows, plan.warps) == (1, 3) and blocks == 171


@pytest.mark.parametrize("bad", [(0, 40, 132), (4, -1, 132), (4, 40, 0)])
def test_sparse_plan_refuses_what_the_kernel_does_not_take(bad):
    with pytest.raises(ValueError):
        tserve._sparse_plan(*bad)


class _FakeFn:
    """A C function of a fake library: records its arguments."""

    def __init__(self):
        self.argtypes, self.restype, self.calls = None, None, []

    def __call__(self, *args):
        assert self.argtypes is not None and len(args) == len(self.argtypes)
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_cuda_tensors_reach_the_kernel_with_its_plan(monkeypatch, kind):
    """With a library in place, a CUDA request block goes to its C
    function once, on the current stream (the device entered only when
    it is not the current one), the dense one with ``_dense_plan``'s
    rows and chunk, the sparse one with ``_sparse_plan``'s rows, warps and
    chunk; one launch counted, no plain version called."""
    import types

    from torch._subclasses.fake_tensor import FakeTensorMode

    from alink_tpu_torch.kernels import _build
    fake = types.SimpleNamespace(
        alink_serve_dense=_FakeFn(), alink_serve_sparse=_FakeFn(),
        alink_cuda_error_string=_FakeFn())
    monkeypatch.setattr(tserve, "_fns", None)
    monkeypatch.setattr(_build, "load_library", lambda n: fake)
    monkeypatch.setattr(_build, "current_device", lambda: 0)
    monkeypatch.setattr(_build, "stream_handle", lambda i: 55)
    monkeypatch.setattr(tserve, "_sm_count", lambda i: 132)

    def no_plain(*a):
        raise AssertionError("a CUDA tensor reached a plain version")
    monkeypatch.setattr(tserve, "dense_scores_plain", no_plain)
    monkeypatch.setattr(tserve, "sparse_scores_plain", no_plain)
    tserve.reset_launch_counts()
    with FakeTensorMode():
        mdl = (torch.zeros(1024, device="cuda"),
               torch.zeros((), device="cuda"))
        if kind == "dense":
            out = tserve.dense_scores(mdl, torch.zeros((512, 1024),
                                                       device="cuda"), "f32")
        else:
            out = tserve.sparse_scores(
                mdl, torch.zeros((512, 40), dtype=torch.int32,
                                 device="cuda"),
                torch.zeros((512, 40), device="cuda"), "f32")
        assert out.shape == (512,) and out.dtype == torch.float32
    (args,) = getattr(fake, f"alink_serve_{kind}").calls
    assert args[0] == 0 and args[-1] == 55            # f32 mode, the stream
    if kind == "dense":
        assert args[6:10] == (512, 1024, 3, 512)      # n, dim, rows, chunk
    else:   # n, width, dim, rows, warps, chunk
        assert args[7:13] == (512, 40, 1024, 1, 3, 64)
    assert tserve.launch_counts() == {"serve_dense": int(kind == "dense"),
                                      "serve_sparse": int(kind == "sparse")}
