"""The port's FTRL state kernels on the CPU: their plain versions against
the JAX package's ops, and no fallback off the CPU.

``gather_rows`` and ``scatter_add_rows`` (``alink_tpu_torch/kernels/
ftrl.py``) run their plain versions for CPU tensors. Those are held bit
for bit against ``st[flat]`` and ``st.at[flat].add(upd)``, the XLA ops
the JAX package's Pallas kernels are pinned to, on the duplicate fixture
of ``tests/test_kernels.py::test_gather_scatter_units`` with a ``-0.0``
slot that no index names and padded zero updates at slot 0.
``chained_corr``'s plain version is held to the JAX package's einsum at
rtol 1e-12 (float64): the same bound ``test_corr_unit_matches_einsum``
pins for the Pallas kernel, an association-only difference. The CUDA
kernels themselves are held to these plain versions on the card by
``chip_smoke.py``.
"""

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
    out = kf.chained_corr(torch.from_numpy(M), torch.from_numpy(Dk), k)
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
    out = kf.chained_corr(torch.from_numpy(M), torch.from_numpy(D), k)
    assert np.array_equal(_bits(want), _bits(out.numpy()))


def _raises_without_nvcc(monkeypatch, call):
    def no_nvcc():
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    monkeypatch.setattr(kf, "_lib_handle", None)
    monkeypatch.setattr(_build, "_loaded", {})
    with FakeTensorMode():
        with pytest.raises(RuntimeError, match="nvcc"):
            call()


@pytest.mark.parametrize("name", ["gather", "scatter", "chained"])
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
        elif name == "scatter":
            kf.scatter_add_rows(st, ix, torch.zeros(8, device="cuda"))
        else:
            kf.chained_corr(torch.zeros((4, 8, 8), device="cuda"),
                            torch.zeros((4, 8, 2), device="cuda"), 2)
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
    with FakeTensorMode():
        st = torch.zeros(16, device="cuda")
        with pytest.raises(ValueError, match="int32"):
            kf.gather_rows(st, torch.zeros(4, dtype=torch.int64,
                                           device="cuda"))
        with pytest.raises(ValueError, match="C in"):
            kf.scatter_add_rows(torch.zeros((16, 3), device="cuda"),
                                torch.zeros(4, dtype=torch.int32,
                                            device="cuda"),
                                torch.zeros((4, 3), device="cuda"))


def test_plain_versions_do_not_count_launches():
    kf.reset_launch_counts()
    st = torch.zeros(8, dtype=torch.float64)
    ix = torch.tensor([1, 1, 0], dtype=torch.int32)
    kf.gather_rows(st, ix)
    kf.scatter_add_rows(st, ix, torch.ones(3, dtype=torch.float64))
    kf.chained_corr(torch.ones((2, 3, 3), dtype=torch.float64),
                    torch.ones((2, 3, 2), dtype=torch.float64), 1)
    assert kf.launch_counts() == {"ftrl_gather": 0, "ftrl_scatter_add": 0,
                                  "ftrl_chained_corr": 0}
    assert st.tolist() == [1.0, 2.0] + [0.0] * 6


@pytest.mark.parametrize("bad", [16, -1])
@pytest.mark.parametrize("name", ["gather", "scatter"])
def test_out_of_range_slots_raise(name, bad):
    """A slot outside the state raises on the CPU (the kernels fail a
    device-side assert on the card) and leaves the state untouched."""
    st = torch.arange(16, dtype=torch.float64)
    ix = torch.tensor([3, bad, 5], dtype=torch.int32)
    with pytest.raises(IndexError):
        if name == "gather":
            kf.gather_rows(st, ix)
        else:
            kf.scatter_add_rows(st, ix, torch.ones(3, dtype=torch.float64))
    assert st.tolist() == list(range(16))
