"""The port's native host library (``alink_tpu_torch/native``) against
the JAX package's (``alink_tpu/native``) on the CPU.

Both libraries build from their own copy of ``parser.cpp``. Every one of
the eight bindings is held bitwise to the JAX package's on the same
seeded bytes, and each case asserts that the JAX side gave a result (not
its "library absent" ``None``):

* LibSVM with blank lines, CRLF, tabs, a missing final newline,
  ``start_index`` 0, and numbers with exponents, 16-17-digit mantissas,
  ``-0`` and ``inf`` / ``nan``; the field-blocked int16 parse and its
  refusals; the chunked parallel parse and the chunk split;
* numeric CSV with a one-character delimiter and empty cells;
* ``$n$i:v``, ``i:v`` and comma-separated vector literals;
* MurmurHash3 of 0-13-byte and UTF-8 tokens and fixed-width ``S``
  columns, with and without ``mod``;
* the compiled FTRL loop on seeded slots.

A build with no compiler, or one that fails, raises with the reason.
"""

import time

import numpy as np
import pytest

import alink_tpu_torch.native as tn


def _jn():
    """The JAX package's native module, its library loaded. That library
    builds in place at first use, so a parallel test run can find
    another process's build half written: then its loader gives None
    for the process, and the load is tried again."""
    from alink_tpu import native
    for _ in range(120):
        if native.get_lib() is not None:
            return native
        native._tried = False
        time.sleep(0.5)
    raise AssertionError("the JAX package's native library did not load")


def _same(a, b):
    """Bitwise equal arrays (a NaN equal to the same NaN, -0.0 apart from
    0.0), or equal scalars."""
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray)
        assert a.dtype == b.dtype and a.shape == b.shape, (a, b)
        assert a.tobytes() == b.tobytes(), (a, b)
    else:
        assert a == b, (a, b)


def _same_all(got, want):
    assert want is not None, "the JAX package returned no result"
    assert got is not None and len(got) == len(want)
    for g, w in zip(got, want):
        _same(g, w)


NUMBERS = ["1", "-2.5", "3e2", "-4.25E-3", "1.2345678901234567",
           "0.12345678901234567", "98765432109876543", "-0", "-0.0",
           "inf", "-inf", "nan", "1e-320", "2.2250738585072014e-308",
           "+7", "0.1"]


def _libsvm(rng, rows, sep=" ", eol="\n", blank=0.0, start=1):
    lines = []
    for _ in range(rows):
        if rng.rand() < blank:
            lines.append("")
            continue
        k = rng.randint(0, 6)
        idx = np.sort(rng.choice(50, k, replace=False)) + start
        toks = [NUMBERS[rng.randint(len(NUMBERS))]]
        toks += [f"{i}:{NUMBERS[rng.randint(len(NUMBERS))]}" for i in idx]
        lines.append(sep.join(toks))
    return (eol.join(lines) + eol).encode()


LIBSVM_CASES = {
    "plain": dict(),
    "blank_lines": dict(blank=0.3),
    "crlf": dict(eol="\r\n"),
    "tabs": dict(sep="\t"),
    "start_index_0": dict(start=0),
}


@pytest.mark.parametrize("final_newline", [True, False])
@pytest.mark.parametrize("case", sorted(LIBSVM_CASES))
def test_parse_libsvm_bytes(case, final_newline):
    kw = dict(LIBSVM_CASES[case])
    start = kw.get("start", 1)
    data = _libsvm(np.random.RandomState(len(case)), 200, **kw)
    if not final_newline:
        data = data.rstrip(b"\r\n")
    got = tn.parse_libsvm_bytes(data, start)
    _same_all(got, _jn().parse_libsvm_bytes(data, start))
    assert got[0].dtype == np.float64 and got[2].dtype == np.int32


@pytest.mark.parametrize("max_workers", [None, 1, 2, 3])
def test_parse_libsvm_bytes_parallel(max_workers):
    """About 9 MB, so the default splits it into chunks on a pool."""
    block = _libsvm(np.random.RandomState(5), 4000, blank=0.05)
    data = block * (9 * (1 << 20) // len(block) + 1)
    got = tn.parse_libsvm_bytes_parallel(data, 1, max_workers)
    _same_all(got, _jn().parse_libsvm_bytes_parallel(data, 1, max_workers))
    _same_all(got, tn.parse_libsvm_bytes(data, 1))


@pytest.mark.parametrize("k", [1, 2, 3, 7, 64])
@pytest.mark.parametrize("tail", [b"\n", b""])
def test_split_newline_chunks(k, tail):
    data = _libsvm(np.random.RandomState(k), 37).rstrip(b"\n") + tail
    got = tn.split_newline_chunks(data, k)
    assert got == _jn().split_newline_chunks(data, k)
    assert b"".join(got) == data


def _fb_rows(rng, rows, n_fields, field_size, start=1):
    fb = rng.randint(0, field_size, (rows, n_fields))
    y = rng.choice([-1, 1, 0], rows)
    flat = fb + np.arange(n_fields) * field_size + start
    lines = [" ".join([str(y[i])] + [f"{j}:1" for j in flat[i]])
             for i in range(rows)]
    return ("\n".join(lines) + "\n").encode()


@pytest.mark.parametrize("case", ["one_hot", "start_index_0", "crlf",
                                  "two_values", "short_row", "not_one",
                                  "wide_field", "field_order"])
def test_parse_libsvm_fb16(case):
    """Rows of one value 1.0 a field, field by field, parse into int16
    field-local ids; other rows give None in both packages."""
    rng = np.random.RandomState(11)
    F, S, start = 4, 300, 1
    data = _fb_rows(rng, 120, F, S)
    if case == "start_index_0":
        start = 0
        data = _fb_rows(rng, 120, F, S, start=0)
    elif case == "crlf":
        data = data.replace(b"\n", b"\r\n")
    elif case == "two_values":
        data = data.replace(b"\n", b" 1200:1\n", 1)
    elif case == "short_row":
        data = b"1 1:1 301:1\n" + data
    elif case == "not_one":
        data = data.replace(b":1 ", b":2 ", 1)
    elif case == "wide_field":
        S = 40000
        data = _fb_rows(rng, 50, F, S)
    elif case == "field_order":
        data = b"1 301:1 1:1 601:1 901:1\n" + data
    got = tn.parse_libsvm_fb16(data, F, S, start)
    want = _jn().parse_libsvm_fb16(data, F, S, start)
    if case in ("one_hot", "start_index_0", "crlf"):
        _same_all(got, want)
        assert got[1].dtype == np.int16 and got[0].dtype == np.float32
        assert got[1].shape == (120, F)
    else:
        assert got is None and want is None


CSV_CASES = {
    "comma": (",", False),
    "semicolon": (";", False),
    "tab": ("\t", False),
    "pipe_empty_cells": ("|", True),
    "comma_empty_cells": (",", True),
}


@pytest.mark.parametrize("case", sorted(CSV_CASES))
def test_parse_numeric_csv_bytes(case):
    delim, empty = CSV_CASES[case]
    rng = np.random.RandomState(len(case))
    lines = []
    for i in range(60):
        cells = [NUMBERS[rng.randint(len(NUMBERS))] for _ in range(5)]
        if empty and i % 4 == 0:
            cells[rng.randint(5)] = ""
        lines.append(delim.join(cells))
    data = ("\r\n".join(lines) + "\r\n").encode()
    got = tn.parse_numeric_csv_bytes(data, delim)
    _same(got, _jn().parse_numeric_csv_bytes(data, delim))
    assert got.shape == (60, 5) and np.isnan(got).any() == (
        empty or "nan" in data.decode())


VECTOR_CASES = {
    "sized": "$50${}",
    "unsized": "{}",
    "comma": "{}",
    "blank_lines": "{}",
}


@pytest.mark.parametrize("case", sorted(VECTOR_CASES))
def test_parse_vector_lines(case):
    rng = np.random.RandomState(len(case))
    lines = []
    for i in range(80):
        k = rng.randint(1, 7)
        idx = np.sort(rng.choice(50, k, replace=False))
        sep = "," if case == "comma" else " "
        body = sep.join(f"{j}:{NUMBERS[rng.randint(len(NUMBERS))]}"
                        for j in idx)
        lines.append(VECTOR_CASES[case].format(body))
        if case == "blank_lines" and i % 9 == 0:
            lines.append("")
    data = ("\n".join(lines) + "\n").encode()
    got = tn.parse_vector_lines(data)
    _same_all(got, _jn().parse_vector_lines(data))
    assert len(got[0]) == 81


def _tokens(rng):
    toks = [bytes(rng.randint(0, 256, n).astype(np.uint8))
            for n in range(14) for _ in range(3)]
    toks += ["é=ü".encode(), "名字=值".encode(), b"", b"a\x00b",
             "C1=1005".encode()]
    return toks


@pytest.mark.parametrize("seed", [0, 104729, 2 ** 32 - 1])
@pytest.mark.parametrize("mod", [0, 1, 7, 30000, 1 << 20])
@pytest.mark.parametrize("kind", ["list", "fixed_width"])
def test_murmur32_batch(kind, mod, seed):
    tokens = _tokens(np.random.RandomState(seed % 1000))
    if kind == "fixed_width":
        # the "S" contract: a token's trailing NULs are not hashed
        tokens = np.array([t.rstrip(b"\x00") for t in tokens])
    got = tn.murmur32_batch(tokens, seed=seed, mod=mod)
    _same(got, _jn().murmur32_batch(tokens, seed=seed, mod=mod))
    assert got.dtype == np.int64
    assert (got >= 0).all() and (mod <= 0 or (got < mod).all())


@pytest.mark.parametrize("rows", [1, 64])
def test_ftrl_slot_run(rows):
    rng = np.random.RandomState(rows)
    dim, width = 97, 9
    idx = rng.randint(0, dim, (rows, width)).astype(np.int32)
    val = rng.randn(rows, width)
    val[:, -2:] = 0.0                    # padding entries
    y = (rng.rand(rows) < 0.5).astype(np.float64)
    z0, n0 = rng.randn(dim), rng.rand(dim) * 3
    hp = dict(alpha=0.05, beta=1.0, l1=1e-2, l2=1e-3)
    z1, n1, z2, n2 = z0.copy(), n0.copy(), z0.copy(), n0.copy()
    assert tn.ftrl_slot_run(idx, val, y, z1, n1, **hp) is None
    assert _jn().ftrl_slot_run(idx, val, y, z2, n2, **hp) is True
    _same(z1, z2)
    _same(n1, n2)
    assert not np.array_equal(z1, z0)


def test_ftrl_slot_run_checks_its_arrays():
    idx = np.array([[0, 5]], np.int32)
    z, n = np.zeros(4), np.zeros(4)
    with pytest.raises(ValueError, match="outside"):
        tn.ftrl_slot_run(idx, np.ones((1, 2)), np.ones(1), z, n,
                         1.0, 1.0, 0.0, 0.0)
    with pytest.raises(ValueError, match="float64"):
        tn.ftrl_slot_run(idx[:, :1], np.ones((1, 1)), np.ones(1),
                         z.astype(np.float32), n, 1.0, 1.0, 0.0, 0.0)


@pytest.mark.parametrize("how", ["no_compiler", "compiler_fails"])
def test_a_failed_build_raises(how, tmp_path, monkeypatch):
    """No compiler on the PATH, or a compiler that exits non-zero: the
    build raises with the reason, and leaves no library behind."""
    out = tmp_path / "libparser-test.so"
    if how == "no_compiler":
        monkeypatch.setattr(tn, "COMPILERS", (str(tmp_path / "missing-c++"),))
        match = "no C\\+\\+ compiler"
    else:
        monkeypatch.setattr(tn, "FLAGS", tn.FLAGS + ("-no-such-flag-x",))
        match = "no-such-flag-x"
    with pytest.raises(RuntimeError, match=match):
        tn.compile_library(out)
    assert list(tmp_path.iterdir()) == []
