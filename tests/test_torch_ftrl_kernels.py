"""The port's FTRL state kernels on the CPU: their plain versions against
the JAX package's ops, and no fallback off the CPU.

``gather_rows``, ``gather_pair`` and ``scatter_add_rows``
(``alink_tpu_torch/kernels/ftrl.py``) run their plain versions for CPU
tensors. Those are held bit for bit against ``st[flat]`` (of the stacked
state, or of ``z`` and ``n`` for the pair) and ``st.at[flat].add(upd)``,
the XLA ops
the JAX package's Pallas kernels are pinned to, on the duplicate fixture
of ``tests/test_kernels.py::test_gather_scatter_units`` with a ``-0.0``
slot that no index names and padded zero updates at slot 0.
``chained_corr``'s plain version is held to the JAX package's einsum at
rtol 1e-12 (float64): the same bound ``test_corr_unit_matches_einsum``
pins for the Pallas kernel, an association-only difference.
``walk_chunk``'s plain version, which walks a chunk of the strict steps
with that correction (or the per-sample step's), is held bitwise to the
per-sample loops it replaces with their margin summed in its pinned
order, and to those loops as they were at the JAX tolerance. The CUDA
kernels themselves are held to these plain versions on the card by
``chip_smoke.py``.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from alink_tpu_torch.kernels import _build
from alink_tpu_torch.kernels import ftrl as kf

DTYPES = [(np.float32, torch.float32), (np.float64, torch.float64)]


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int64) if a.dtype == np.float64 else a.view(np.int32)


def _dup_fixture(C, np_dtype):
    """tests/test_kernels.py's duplicate fixture, plus 12 padded
    positions (slot 0, update 0.0) and a -0.0 stored at slot 0."""
    rng = np.random.RandomState(0)
    st = rng.randn(300, 2)
    st[7] = [-0.0, 0.0]
    st[0] = [-0.0, -0.0]
    idx = rng.randint(0, 300, 50).astype(np.int32)
    idx[3] = idx[9] = idx[11]                 # duplicates
    idx = idx[idx != 7]
    upd = rng.randn(idx.size, 2)
    idx = np.concatenate([idx, np.zeros(12, np.int32)])
    upd = np.concatenate([upd, np.zeros((12, 2))])
    if C == 1:
        st, upd = st[:, 0], upd[:, 0]
    return (np.ascontiguousarray(st, np_dtype), idx,
            np.ascontiguousarray(upd, np_dtype))


@pytest.mark.parametrize("C", [1, 2])
@pytest.mark.parametrize("np_dtype,t_dtype", DTYPES)
def test_gather_plain_bitwise_vs_jax(C, np_dtype, t_dtype):
    st, idx, _ = _dup_fixture(C, np_dtype)
    ref = jnp.asarray(st)[jnp.asarray(idx)]
    out = kf.gather_rows(torch.from_numpy(st), torch.from_numpy(idx))
    assert out.dtype == t_dtype
    assert np.array_equal(_bits(ref), _bits(out.numpy()))


@pytest.mark.parametrize("np_dtype,t_dtype", DTYPES)
def test_gather_pair_plain_bitwise_vs_jax(np_dtype, t_dtype):
    """(z[idx], n[idx]) stacked, as the JAX package gathers each of the
    two states: duplicate-heavy slots, the padded positions at slot 0
    (whose -0.0 values keep their sign) and a -0.0 slot that no index
    names; the same bits as ``gather_rows`` of the (S, 2) stack."""
    st, idx, _ = _dup_fixture(2, np_dtype)
    z, n = np.ascontiguousarray(st[:, 0]), np.ascontiguousarray(st[:, 1])
    flat = jnp.asarray(idx)
    ref = np.stack([np.asarray(jnp.asarray(z)[flat]),
                    np.asarray(jnp.asarray(n)[flat])], -1)
    out = kf.gather_pair(torch.from_numpy(z), torch.from_numpy(n),
                         torch.from_numpy(idx))
    assert out.dtype == t_dtype and out.shape == (idx.size, 2)
    assert np.array_equal(_bits(ref), _bits(out.numpy()))
    assert torch.signbit(out[-1]).all() and not out[-1].any()
    stacked = kf.gather_rows(torch.from_numpy(st), torch.from_numpy(idx))
    assert np.array_equal(_bits(stacked.numpy()), _bits(out.numpy()))


@pytest.mark.parametrize("C", [1, 2])
@pytest.mark.parametrize("np_dtype,t_dtype", DTYPES)
def test_scatter_plain_bitwise_vs_jax(C, np_dtype, t_dtype):
    """Duplicates add in update order; the untouched -0.0 slot keeps its
    bits; the padded zero adds at slot 0 land, turning its -0.0 into
    +0.0 as the JAX package's do."""
    st, idx, upd = _dup_fixture(C, np_dtype)
    ref = np.asarray(jnp.asarray(st).at[jnp.asarray(idx)].add(
        jnp.asarray(upd)))
    state = torch.from_numpy(st.copy())
    out = kf.scatter_add_rows(state, torch.from_numpy(idx),
                              torch.from_numpy(upd))
    assert out is state                       # updated in place
    assert np.array_equal(_bits(ref), _bits(out.numpy()))
    neg = out[7] if C == 1 else out[7, 0]
    assert torch.signbit(neg) and float(neg) == 0.0
    zero = ref[0] if C == 1 else ref[0, 0]
    assert not np.signbit(zero)               # -0.0 + 0.0 in JAX: +0.0


@pytest.mark.parametrize("np_dtype,t_dtype", DTYPES)
def test_scatter_plain_is_the_in_order_loop(np_dtype, t_dtype):
    """The contract the CUDA kernel is held to on the card: one rounded
    add per update, in update order, slot by slot."""
    rng = np.random.RandomState(4)
    st = rng.randn(40).astype(np_dtype)
    idx = rng.randint(0, 6, 90).astype(np.int32)      # heavy duplicates
    upd = (rng.randn(90) * 10.0 ** rng.randint(-6, 6, 90)).astype(np_dtype)
    want = st.copy()
    for m in range(idx.size):
        want[idx[m]] = np_dtype(want[idx[m]] + upd[m])
    out = kf.scatter_add_rows(torch.from_numpy(st.copy()),
                              torch.from_numpy(idx), torch.from_numpy(upd))
    assert np.array_equal(_bits(want), _bits(out.numpy()))


@pytest.mark.parametrize("k", [0, 1, 7])
def test_chained_plain_matches_jax_einsum(k):
    """tests/test_kernels.py::test_corr_unit_matches_einsum's fixture:
    within rtol 1e-12 of the HIGHEST-precision einsum with rows j >= k
    zeroed (float64)."""
    rng = np.random.RandomState(0)
    K, w = 8, 10
    M = (rng.rand(K, w, w) < 0.1).astype(np.float64)
    D = rng.randn(K, w, 2)
    Dk = D.copy()
    Dk[k:] = 0.0
    ref = jnp.einsum("jab,jbc->ac", jnp.asarray(M), jnp.asarray(Dk),
                     precision=jax.lax.Precision.HIGHEST)
    out = kf.chained_corr_plain(torch.from_numpy(M), torch.from_numpy(Dk), k)
    assert out.shape == (w, 2) and out.dtype == torch.float64
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-14)


@pytest.mark.parametrize("np_dtype,t_dtype", DTYPES)
@pytest.mark.parametrize("k", [1, 5, 7])
def test_chained_plain_is_the_ordered_chain(k, np_dtype, t_dtype):
    """The contract the CUDA kernel is held to on the card: per output,
    the products added in the order (j, b) from +0.0, each product and
    each add rounded on its own — bitwise, on dense 0/1 rows where the
    order matters."""
    rng = np.random.RandomState(k)
    K, w = 8, 10
    M = (rng.rand(K, w, w) < 0.5).astype(np_dtype)
    D = (rng.randn(K, w, 2) * 10.0 ** rng.randint(-4, 4, (K, w, 2))
         ).astype(np_dtype)
    want = np.zeros((w, 2), np_dtype)
    for a in range(w):
        for c in range(2):
            acc = np_dtype(0.0)
            for j in range(k):
                for b in range(w):
                    acc = np_dtype(acc + np_dtype(M[j, a, b] * D[j, b, c]))
            want[a, c] = acc
    out = kf.chained_corr_plain(torch.from_numpy(M), torch.from_numpy(D), k)
    assert np.array_equal(_bits(want), _bits(out.numpy()))


HP = (0.05, 1.0, 1e-5, 1e-5)                  # alpha, beta, l1, l2


def _walk_fixture(kind, K, np_dtype, seed=0):
    """A chunk of K rows of width 16 with 12 live slots (the rest padded
    to slot 0 with value 0) over a 300-slot state with a -0.0 slot: the
    rows' slots distinct (``"distinct"``), every row on slot 0 as
    Criteo rows share the intercept (``"intercept"``), or rows drawing
    from 30 slots without repeats inside a row (``"collide"``)."""
    rng = np.random.RandomState(seed)
    w, nnz = 16, 12
    xi = np.zeros((K, w), np.int32)
    for k in range(K):
        pool = 30 if kind == "collide" else 300
        xi[k, :nnz] = rng.choice(np.arange(1, pool), nnz, replace=False)
        if kind == "intercept":
            xi[k, 0] = 0
    if kind == "distinct":
        xi[:, :nnz] = rng.choice(np.arange(1, 300), (K * nnz),
                                 replace=False).reshape(K, nnz)
    xv = np.zeros((K, w))
    xv[:, :nnz] = rng.randn(K, nnz)
    yy = (rng.rand(K) < 0.5).astype(np.float64)
    st = rng.randn(300, 2) * 0.1
    st[:, 1] = np.abs(st[:, 1])
    st[xi[0, 3], 0] = -0.0
    zn = st[xi.reshape(-1)]
    return tuple(torch.from_numpy(np.ascontiguousarray(a, t))
                 for a, t in ((xi, np.int32), (xv, np_dtype),
                              (yy, np_dtype), (zn, np_dtype)))


def _per_sample_loop(xi, xv, yy, zn, chained, margin_sum):
    """The strict steps' per-sample loops as the port ran them before the
    walk (one chained correction, or one same-slot selection per earlier
    sample, then the weights, margin and deltas of each sample), with the
    margin summed by ``margin_sum``. Returns ((K, w, 2) deltas, margins)."""
    alpha, beta, l1, l2 = HP
    K, w = xi.shape
    zn = zn.view(K, w, 2)
    same = xi[:, None, :, None] == xi[None, :, None, :]
    D = torch.zeros((K, w, 2), dtype=zn.dtype)
    margins = []
    for k in range(K):
        if chained:
            corr = kf.chained_corr_plain(same.to(zn.dtype)[k], D, k)
            zk, nk = zn[k, :, 0] + corr[:, 0], zn[k, :, 1] + corr[:, 1]
        else:
            znk = zn[k]
            for j in range(k):
                znk = znk + torch.where(same[k, j][:, :, None], D[j][None],
                                        0.0).sum(1)
            zk, nk = znk[:, 0], znk[:, 1]
        wk = kf.ftrl_weights(zk, nk, alpha, beta, l1, l2)
        margin = margin_sum(xv[k] * wk)
        g = (kf.sigmoid(margin) - yy[k]) * xv[k]
        gg = g * g
        sigma = (torch.sqrt(nk + gg) - torch.sqrt(nk)) / alpha
        D[k] = torch.stack([g - sigma * wk, gg], -1)
        margins.append(margin)
    return D, torch.stack(margins)


@pytest.mark.parametrize("kind", ["distinct", "intercept", "collide"])
@pytest.mark.parametrize("np_dtype,t_dtype", DTYPES)
@pytest.mark.parametrize("chained", [False, True])
def test_walk_plain_is_the_per_sample_loop(chained, np_dtype, t_dtype, kind):
    """``walk_chunk_plain`` (K = 4 in the sample form, 8 chained) against
    the per-sample loop it replaces: bitwise, deltas and margins, once the
    loop sums its margin in the walk's pinned order (``tree_sum``); with
    the loop's own ``torch.sum`` the margins' last bits move, and the loop
    as it was is held at the JAX tolerance (rtol 1e-12, atol 1e-14 in
    float64; rtol 1e-5, atol 1e-6 in float32)."""
    K = 8 if chained else 4
    xi, xv, yy, zn = _walk_fixture(kind, K, np_dtype)
    margins = torch.full((K + 3,), 7.0, dtype=t_dtype)
    d = kf.walk_chunk(xi, xv, yy, zn, margins, 2, *HP, chained=chained)
    assert d.shape == (2, K * 16) and d.dtype == t_dtype
    assert d.is_contiguous() and (margins[:2] == 7).all()
    assert (margins[-1] == 7).all()
    got = (d.view(2, K, 16).permute(1, 2, 0).numpy(), margins[2:2 + K].numpy())
    D, m = _per_sample_loop(xi, xv, yy, zn, chained, kf.tree_sum)
    for a, b in zip(got, (D.numpy(), m.numpy())):
        assert np.array_equal(_bits(a), _bits(b))
    D, m = _per_sample_loop(xi, xv, yy, zn, chained, torch.sum)
    tol = dict(rtol=1e-12, atol=1e-14) if np_dtype == np.float64 else \
        dict(rtol=1e-5, atol=1e-6)
    for a, b in zip(got, (D.numpy(), m.numpy())):
        np.testing.assert_allclose(a, b, **tol)


@pytest.mark.parametrize("np_dtype,t_dtype", DTYPES)
def test_ordered_partials_add_in_slot_order(np_dtype, t_dtype):
    """The per-sample form's partial with several matches (a row that
    repeats a slot): the selected deltas of each earlier sample added in
    the order of their position from +0.0, bitwise; a NaN delta at a slot
    that does not match never leaks."""
    rng = np.random.RandomState(5)
    k, w = 3, 10
    sel = rng.rand(k, w, w) < 0.4
    D = (rng.randn(k, w, 2) * 10.0 ** rng.randint(-4, 4, (k, w, 2))
         ).astype(np_dtype)
    D[0, 0] = np.nan
    sel[0, :, 0] = False
    want = np.zeros((k, w, 2), np_dtype)
    for j in range(k):
        for a in range(w):
            for b in range(w):
                if sel[j, a, b]:
                    want[j, a] = (want[j, a] + D[j, b]).astype(np_dtype)
    got = kf._ordered_partials(torch.from_numpy(sel), torch.from_numpy(D))
    assert got.dtype == t_dtype
    assert np.array_equal(_bits(want), _bits(got.numpy()))


def test_tree_sum_is_the_pairwise_tree():
    """``tree_sum`` pads to a power of two with +0.0 and adds halves:
    for 5 terms ((t0 + t4) + t2) + (t1 + t3) in float32 (2.0 here, where
    a left-to-right sum gives 4.0), one term alone unchanged (a -0.0
    kept)."""
    t = torch.tensor([1e8, 1.0, -1e8, 1.0, 3.0], dtype=torch.float32)
    f = np.float32
    want = f(f(f(1e8) + f(3.0)) + f(-1e8)) + f(f(1.0) + f(1.0))
    assert kf.tree_sum(t).item() == want == 2.0
    one = kf.tree_sum(torch.tensor([-0.0]))
    assert one.item() == 0.0 and torch.signbit(one)
    rows = torch.randn(3, 40, dtype=torch.float64)
    assert torch.equal(kf.tree_sum(rows), torch.stack(
        [kf.tree_sum(r) for r in rows]))


def _raises_without_nvcc(monkeypatch, call):
    def no_nvcc():
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    monkeypatch.setattr(kf, "_fns", None)
    monkeypatch.setattr(_build, "_loaded", {})
    with FakeTensorMode():
        with pytest.raises(RuntimeError, match="nvcc"):
            call()


def _walk_args(device, dtype=torch.float32, K=4, w=8):
    """``walk_chunk``'s operands for a chunk of K rows of width w."""
    return (torch.zeros((K, w), dtype=torch.int32, device=device),
            torch.zeros((K, w), dtype=dtype, device=device),
            torch.zeros(K, dtype=dtype, device=device),
            torch.ones((K * w, 2), dtype=dtype, device=device),
            torch.zeros(2 * K, dtype=dtype, device=device), K,
            0.05, 1.0, 1e-5, 1e-5)


@pytest.mark.parametrize("name", ["gather", "pair", "scatter", "walk"])
def test_cuda_tensors_launch_or_raise(monkeypatch, name):
    """A CUDA tensor never falls back to the plain version: without a
    card (and a compiler) the wrapper raises."""
    monkeypatch.setattr(_build, "_target",
                        lambda n: _build.BUILD_DIR / "missing-lib.so")

    def call():
        st = torch.zeros(64, device="cuda")
        ix = torch.zeros(8, dtype=torch.int32, device="cuda")
        if name == "gather":
            kf.gather_rows(st, ix)
        elif name == "pair":
            kf.gather_pair(st, torch.zeros(64, device="cuda"), ix)
        elif name == "scatter":
            kf.scatter_add_rows(st, ix, torch.zeros(8, device="cuda"))
        else:
            kf.walk_chunk(*_walk_args("cuda"), chained=True)
    before = kf.launch_counts()
    _raises_without_nvcc(monkeypatch, call)
    assert kf.launch_counts() == before


def test_wrappers_reject_what_the_kernels_do_not_take():
    """Off the CPU the wrappers check before they launch: a device other
    than CUDA, an int64 index, a state of more than two columns."""
    meta = torch.zeros(16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        kf.gather_rows(meta, torch.zeros(4, dtype=torch.int32,
                                         device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        kf.gather_pair(meta, meta, torch.zeros(4, dtype=torch.int32,
                                               device="meta"))
    with FakeTensorMode():
        st = torch.zeros(16, device="cuda")
        with pytest.raises(ValueError, match="int32"):
            kf.gather_rows(st, torch.zeros(4, dtype=torch.int64,
                                           device="cuda"))
        with pytest.raises(ValueError, match="int32"):
            kf.gather_pair(st, st, torch.zeros(4, dtype=torch.int64,
                                               device="cuda"))
        with pytest.raises(ValueError, match="one dtype"):
            kf.gather_pair(st, torch.zeros(16, dtype=torch.float64,
                                           device="cuda"),
                           torch.zeros(4, dtype=torch.int32, device="cuda"))
        with pytest.raises(ValueError, match="C in"):
            kf.scatter_add_rows(torch.zeros((16, 3), device="cuda"),
                                torch.zeros(4, dtype=torch.int32,
                                            device="cuda"),
                                torch.zeros((4, 3), device="cuda"))
        xi, xv, yy, zn, mg, row, *hp = _walk_args("cuda")
        strided = torch.empty_strided((4, 8), (1, 4), dtype=torch.int32,
                                      device="cuda")
        for bad in ({"xi": xi.long()}, {"zn": zn.double()}, {"row": 5},
                    {"xv": torch.zeros((4, 4), device="cuda")},
                    {"xi": strided}):
            args = dict(xi=xi, xv=xv, yy=yy, zn=zn, margins=mg, row=row)
            args.update(bad)
            with pytest.raises(ValueError, match="walk_chunk: want"):
                kf.walk_chunk(**args, alpha=hp[0], beta=hp[1], l1=hp[2],
                              l2=hp[3], chained=False)
        # as many positions as the chunk's scatter-add takes, no more
        with pytest.raises(ValueError, match="at most 11264"):
            kf.walk_chunk(*_walk_args("cuda", K=1, w=11265), chained=False)
        with pytest.raises(ValueError, match="at most 11264"):
            kf.walk_chunk(*_walk_args("cuda", K=16, w=705), chained=True)


def test_plain_versions_do_not_count_launches():
    kf.reset_launch_counts()
    st = torch.zeros(8, dtype=torch.float64)
    ix = torch.tensor([1, 1, 0], dtype=torch.int32)
    kf.gather_rows(st, ix)
    kf.gather_pair(st, st, ix)
    kf.scatter_add_rows(st, ix, torch.ones(3, dtype=torch.float64))
    d = kf.walk_chunk(*_walk_args("cpu", torch.float64), chained=True)
    assert d.shape == (2, 32)
    assert kf.launch_counts() == {"ftrl_gather": 0, "ftrl_gather_pair": 0,
                                  "ftrl_scatter_add": 0, "ftrl_walk": 0}
    assert st.tolist() == [1.0, 2.0] + [0.0] * 6


@pytest.mark.parametrize("bad", [16, -1])
@pytest.mark.parametrize("name", ["gather", "pair", "scatter"])
def test_out_of_range_slots_raise(name, bad):
    """A slot outside the state raises on the CPU (the kernels fail a
    device-side assert on the card) and leaves the state untouched."""
    st = torch.arange(16, dtype=torch.float64)
    ix = torch.tensor([3, bad, 5], dtype=torch.int32)
    with pytest.raises(IndexError):
        if name == "gather":
            kf.gather_rows(st, ix)
        elif name == "pair":
            kf.gather_pair(st, st, ix)
        else:
            kf.scatter_add_rows(st, ix, torch.ones(3, dtype=torch.float64))
    assert st.tolist() == list(range(16))


@pytest.mark.parametrize("C", [1, 2])
@pytest.mark.parametrize("np_dtype,t_dtype", DTYPES)
@pytest.mark.parametrize("case", ["one_slot_chain", "single_update"])
def test_scatter_plain_runs_bitwise_vs_jax(case, C, np_dtype, t_dtype):
    """The runs the sorted kernel must get right: every position on one
    slot (one chain of 1280 adds in update order) and a single update,
    against the XLA scatter-add the JAX package's kernel is pinned to."""
    rng = np.random.RandomState(9)
    st = rng.randn(300, 2)
    st[7] = [-0.0, -0.0]
    if case == "one_slot_chain":
        idx = np.full(1280, 123, np.int32)
        upd = rng.randn(1280, 2) * 10.0 ** rng.randint(-6, 6, (1280, 1))
    else:
        idx = np.array([45], np.int32)
        upd = rng.randn(1, 2)
    if C == 1:
        st, upd = st[:, 0], upd[:, 0]
    st = np.ascontiguousarray(st, np_dtype)
    upd = np.ascontiguousarray(upd, np_dtype)
    ref = np.asarray(jnp.asarray(st).at[jnp.asarray(idx)].add(
        jnp.asarray(upd)))
    out = kf.scatter_add_rows(torch.from_numpy(st.copy()),
                              torch.from_numpy(idx), torch.from_numpy(upd))
    assert out.dtype == t_dtype
    assert np.array_equal(_bits(ref), _bits(out.numpy()))
    neg = out[7] if C == 1 else out[7, 0]
    assert torch.signbit(neg) and float(neg) == 0.0


class _FakeFn:
    """A C function of a fake library: records its arguments and checks
    them against the argtypes the wrapper declared."""

    def __init__(self):
        self.argtypes, self.restype, self.calls = None, None, []

    def __call__(self, *args):
        assert self.argtypes is not None and len(args) == len(self.argtypes)
        for a, kind in zip(args, self.argtypes):
            assert isinstance(a, float if kind is ctypes.c_double else int)
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("name", ["gather", "pair", "scatter", "walk"])
def test_cuda_tensors_reach_the_kernel_not_the_plain_version(monkeypatch,
                                                            name):
    """With a library in place, a CUDA tensor goes to its C function once,
    on the current stream, and counts one launch; the plain versions are
    never called."""
    import types
    fake = types.SimpleNamespace(**{n: _FakeFn() for n in (
        "alink_ftrl_gather", "alink_ftrl_gather_pair",
        "alink_ftrl_scatter_add", "alink_ftrl_walk",
        "alink_ftrl_walk_spill", "alink_ftrl_error_string")})
    monkeypatch.setattr(kf, "_fns", None)
    kf._walk_spill.cache_clear()
    monkeypatch.setattr(_build, "load_library", lambda n: fake)
    monkeypatch.setattr(_build, "current_device", lambda: 0)
    monkeypatch.setattr(_build, "stream_handle", lambda i: 55)

    def no_plain(*a):
        raise AssertionError("a CUDA tensor reached a plain version")
    for plain in ("gather_rows_plain", "gather_pair_plain",
                  "scatter_add_rows_plain", "walk_chunk_plain"):
        monkeypatch.setattr(kf, plain, no_plain)
    kf.reset_launch_counts()
    with FakeTensorMode():
        st = torch.zeros((64, 2), device="cuda")
        ix = torch.zeros(8, dtype=torch.int32, device="cuda")
        if name == "gather":
            kf.gather_rows(st, ix)
        elif name == "pair":
            kf.gather_pair(torch.zeros(64, device="cuda"),
                           torch.zeros(64, device="cuda"), ix)
        elif name == "scatter":
            kf.scatter_add_rows(st, ix, torch.zeros((8, 2), device="cuda"))
        else:
            walk = _walk_args("cuda")
            kf.walk_chunk(*walk, chained=True)
    fn = {"gather": fake.alink_ftrl_gather,
          "pair": fake.alink_ftrl_gather_pair,
          "scatter": fake.alink_ftrl_scatter_add,
          "walk": fake.alink_ftrl_walk}[name]
    (args,) = fn.calls
    assert args[0] == 0 and args[-1] == 55            # float32, the stream
    if name == "walk":
        # chained; K = 4 rows of 8; margins from row 4; beta, l1, l2 and
        # 1 / alpha rounded to float32; no spill (the library asked for
        # none at this shape)
        mg = walk[4]
        assert args[1] == 1 and args[8:10] == (4, 8)
        assert args[6] == mg.data_ptr() + 4 * mg.element_size()
        assert args[10:] == (1.0, 1e-5, 1e-5, 20.0, 0, 55)
        assert (0, 4, 8) in fake.alink_ftrl_walk_spill.calls
    counted = {"gather": "ftrl_gather", "pair": "ftrl_gather_pair",
               "scatter": "ftrl_scatter_add", "walk": "ftrl_walk"}[name]
    assert kf.launch_counts() == {k: int(k == counted) for k in (
        "ftrl_gather", "ftrl_gather_pair", "ftrl_scatter_add",
        "ftrl_walk")}


@pytest.mark.parametrize("mode", ["sample", "chained"])
def test_steps_gather_z_and_n_in_one_call_per_chunk(monkeypatch, mode):
    """The per-sample and chained steps take each chunk's slots of z and
    n in ONE gather_pair call (one launch on the card), and gather_rows
    not at all: 2 chunks of 4 rows, 1 chunk of 16."""
    from alink_tpu_torch.operator.stream.onlinelearning import ftrl as op
    calls = {"pair": 0, "rows": 0}

    def counting(name, fn):
        def call(*a):
            calls[name] += 1
            return fn(*a)
        return call
    monkeypatch.setattr(op, "gather_pair", counting("pair", kf.gather_pair))
    monkeypatch.setattr(op, "gather_rows", counting("rows", kf.gather_rows))
    rng = np.random.RandomState(3)
    idx = torch.from_numpy(rng.randint(0, 50, (8, 8)).astype(np.int32))
    val = torch.from_numpy(rng.randn(8, 8))
    y = torch.from_numpy((rng.rand(8) < 0.5).astype(np.float64))
    z, n = torch.zeros(50, dtype=torch.float64), torch.ones(50,
                                                           dtype=torch.float64)
    hp = dict(alpha=0.05, beta=1.0, l1=1e-5, l2=1e-5)
    if mode == "sample":
        op.ftrl_sample_step(idx, val, y, z, n, **hp)
    else:
        op.ftrl_chained_step(idx, val, y, z, n, **hp, K=16)
    assert calls == {"pair": 2 if mode == "sample" else 1, "rows": 0}
