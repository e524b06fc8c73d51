"""The port's native host encoders (keto_tpu_torch/native) against their
numpy plain versions and keto_tpu's native ones, on the CPU: the
sorted-unique encoding (unique_encode, sorted_unique_encode) and the
round-based probe-table builder (build_probe_table, through
snapshot._build_hash_table) under both table layouts, on the cases of
tests/test_native.py (empty input, all duplicates, mixed widths, NUL and
high bytes, concurrent calls, the 64-round overflow signal, the grow
path), and a broken source raising its compiler's output.

Tolerance: exact equality (integer arrays and byte strings).
"""

import shutil
import threading

import numpy as np
import pytest

import keto_tpu.engine.snapshot as jsnap
import keto_tpu.native as jnative

import keto_tpu_torch.engine.snapshot as tsnap
import keto_tpu_torch.native as tnative

from test_torch_kernel import layout  # noqa: F401  (a fixture)


def _numpy_triple(keys):
    uniq, first = np.unique(keys, return_index=True)
    return uniq, first, np.searchsorted(uniq, keys).astype(np.int32)


def _assert_encodes(keys):
    want = _numpy_triple(keys)
    jgot = jnative.sorted_unique_encode(keys)
    for fn in (tnative.unique_encode, tnative.sorted_unique_encode):
        got = fn(keys)
        for g, w, j in zip(got, want, jgot):
            assert g.dtype == w.dtype and g.dtype.kind == j.dtype.kind
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, j)


def _mixed_width_keys():
    rng = np.random.default_rng(5)
    out = []
    for w in (1, 7, 24, 36, 64):
        base = np.array([f"k{i}".encode().ljust(w, b"\x00")[:w] for i in range(257)],
                        dtype=f"S{w}")
        out.append(base[rng.integers(0, len(base), 4096)])
    return out


ENCODE_CASES = {
    "empty": [np.array([], dtype="S8")],
    "single": [np.array([b"a"], dtype="S4")],
    "all_dupes": [np.array([b"x"] * 17, dtype="S2")],
    "mixed_widths": _mixed_width_keys(),
    # composite keys embed ns ids as raw bytes, NULs and bytes past 0x7f
    "nul_and_high_bytes": [np.array([b"\x00\x01abc", b"\xff\xfe\x00x", b"\x00\x01abc",
                                     b"\x7f" * 6], dtype="S6")],
    "utf8_names": [np.char.encode(np.array(["café", "über\x1fx", "", "café",
                                            "z中", "\x1f"], dtype="U"), "utf-8")],
}


@pytest.mark.parametrize("case", sorted(ENCODE_CASES))
def test_unique_encode_equals_numpy_and_keto_tpu(case):
    for keys in ENCODE_CASES[case]:
        _assert_encodes(keys)


def test_first_occurrence_contract():
    keys = np.array([b"b", b"a", b"b", b"a", b"c"], dtype="S1")
    uniq, first, codes = tnative.sorted_unique_encode(keys)
    np.testing.assert_array_equal(uniq, np.array([b"a", b"b", b"c"], "S1"))
    np.testing.assert_array_equal(first, [1, 0, 4])
    np.testing.assert_array_equal(codes, [1, 0, 1, 0, 2])


def test_unique_encode_refuses_other_dtypes():
    with pytest.raises(TypeError):
        tnative.unique_encode(np.array(["a", "b"], dtype="U"))
    with pytest.raises(TypeError):
        tnative.unique_encode(np.zeros((2, 2), dtype="S2"))


def test_concurrent_calls_are_isolated():
    """ctypes drops the GIL for the call: encodes on several threads at
    once each get their own answer."""
    rng = np.random.default_rng(7)
    base = np.array([f"k{i}".encode().ljust(16, b"\x00") for i in range(500)], dtype="S16")
    arrays = [base[rng.integers(0, 500, 50_000)] for _ in range(4)]
    wants = [_numpy_triple(a) for a in arrays]
    errors = []

    def run(i):
        try:
            for _ in range(5):
                for g, w in zip(tnative.sorted_unique_encode(arrays[i]), wants[i]):
                    np.testing.assert_array_equal(g, w)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert errors == []


def _probe_keys(seed, n_cols):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(0, 5000))
    cols = [rng.integers(0, max(n, 1), n).astype(np.int32)]
    cols += [rng.integers(0, 60, n).astype(np.int32) for _ in range(n_cols - 1)]
    return tuple(cols), np.arange(n, dtype=np.int32)


@pytest.mark.parametrize("n_cols", [2, 3, 5])
@pytest.mark.parametrize("seed", range(4))
def test_probe_table_equals_numpy_rounds_and_keto_tpu(layout, n_cols, seed):
    """Every table the port builds (2-key pair tables, 3-key closure
    tables, 5-key edge tables) equals the numpy rounds bit for bit, at
    the boosted and the plain capacity, and keto_tpu's native build under
    the same layout."""
    keys, vals = _probe_keys(seed, n_cols)
    for boost in (True, False):
        got = tsnap._build_hash_table(keys, vals, layout, boost_load=boost)
        want = tsnap._build_hash_table_plain(keys, vals, layout, boost_load=boost)
        jgot = jsnap._build_hash_table(keys, vals, boost_load=boost)
        assert got[-1] == want[-1] == jgot[-1]
        for g, w, j in zip(got[:-1], want[:-1], jgot[:-1]):
            assert g.dtype == w.dtype == np.int32
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, np.asarray(j))


@pytest.mark.parametrize("cap", [64, 128, 256, 1024, 4096])
def test_probe_table_every_capacity(layout, cap):
    """At a fixed capacity the native build returns the numpy rounds'
    table and probe limit, or both signal the 64-round overflow."""
    rng = np.random.default_rng(cap)
    n = cap // 4
    keys = (rng.integers(0, 3, n).astype(np.int32), rng.integers(0, n, n).astype(np.int32))
    vals = np.arange(n, dtype=np.int32)
    h1 = tsnap.hash_combine(*keys)
    h2 = tsnap.mix32(h1 ^ tsnap._GOLDEN) | np.uint32(1)
    spb = tsnap.slots_per_bucket(2, layout)
    cols, out_vals, probes = tnative.build_probe_table(h1, h2, keys, vals, cap, -1, spb)
    jcols, jvals, jprobes = jnative.build_probe_table(h1, h2, keys, vals, cap, -1, spb)
    assert probes == jprobes
    for g, j in zip([*cols, out_vals], [*jcols, jvals]):
        np.testing.assert_array_equal(g, j)


def test_probe_table_overflow_signal():
    """A table too small for its keys hits the 64-round limit and says
    so (-1), never returning a partial table as a build."""
    n = 600
    ka = np.zeros(n, dtype=np.int32)
    kb = np.arange(n, dtype=np.int32)
    h1 = tsnap.hash_combine(ka, kb)
    h2 = tsnap.mix32(h1 ^ tsnap._GOLDEN) | np.uint32(1)
    for spb in (1, 16):
        assert tnative.build_probe_table(h1, h2, (ka, kb), np.arange(n, dtype=np.int32),
                                         64, -1, spb)[2] == -1


def test_probe_table_grow_path(layout, monkeypatch):
    """From a capacity far too small, _build_hash_table doubles until the
    build fits, and lands on the numpy rounds' table."""
    n = 600
    keys = (np.zeros(n, dtype=np.int32), np.arange(n, dtype=np.int32))
    vals = np.arange(n, dtype=np.int32)
    monkeypatch.setattr(tsnap, "hash_table_capacity", lambda n, min_capacity=64: 64)
    got = tsnap._build_hash_table(keys, vals, layout)
    want = tsnap._build_hash_table_plain(keys, vals, layout)
    assert 1 <= got[-1] <= 64 and got[-1] == want[-1]
    assert len(got[-2]) > 64
    for g, w in zip(got[:-1], want[:-1]):
        np.testing.assert_array_equal(g, w)
    present = got[-2][got[-2] != tsnap.EMPTY]
    assert sorted(present.tolist()) == list(range(n))


def test_probe_table_refuses_bad_arguments():
    h = np.zeros(4, dtype=np.uint32)
    keys = (np.zeros(4, dtype=np.int32),)
    with pytest.raises(ValueError):
        tnative.build_probe_table(h, h, keys, np.arange(4, dtype=np.int32), 64, -1, 3)
    with pytest.raises(ValueError):
        tnative.build_probe_table(h, h, keys, np.arange(3, dtype=np.int32), 64, -1, 8)


def test_broken_source_raises_with_the_compiler_output(tmp_path, monkeypatch):
    """A source that does not compile raises RuntimeError with g++'s
    message; nothing falls back to numpy, and no library is left."""
    broken = tmp_path / "fastenc.cpp"
    shutil.copy(tnative.SOURCE, broken)
    broken.write_text(broken.read_text() + "\nthis is not C++;\n")
    monkeypatch.setattr(tnative, "SOURCE", broken)
    monkeypatch.setattr(tnative, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        tnative.unique_encode(np.array([b"a"], dtype="S1"))
    assert "fastenc.cpp" in str(err.value) and "error" in str(err.value)
    assert not tnative.library_path(broken).exists()
    with pytest.raises(RuntimeError):
        tsnap._build_hash_table((np.zeros(4, np.int32),), np.arange(4, dtype=np.int32),
                                "compact")


def test_library_is_named_by_its_source(tmp_path):
    """An edited source gets a new library name, so it builds anew."""
    edited = tmp_path / "fastenc.cpp"
    edited.write_text(tnative.SOURCE.read_text() + "\n// edited\n")
    tnative.library()
    assert tnative.library_path(edited) != tnative.library_path(tnative.SOURCE)
    assert tnative.library_path(tnative.SOURCE).exists()
