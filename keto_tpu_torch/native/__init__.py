"""The host encoders of the mirror build, in C++ (fastenc.cpp), by ctypes.

  - `unique_encode` / `sorted_unique_encode`: the sorted-unique encoding
    of a fixed-width bytes key array (what np.unique with return_index,
    then np.searchsorted, give), by one hash pass over the rows and a
    sort of the uniques only. Every vocabulary of the columnar build and
    the columnar store's dedupe go through it.
  - `build_probe_table`: the round-based open-addressing builder, bit for
    bit the numpy rounds (engine/snapshot._build_hash_table_plain)
    without their argsort a round. Every probe table the port builds
    goes through it.

The library is built with g++ at its first use into keto_tpu_torch/_build/
(named by the content hash of the source and the flags, so an edited
source builds anew), compiled to a temporary name and renamed into place
under a file lock, so that several processes may build it at once. A
failed build raises with the compiler's output; nothing falls back to
numpy. The numpy versions stay beside the callers as the plain versions
the tests hold these to.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().with_name("fastenc.cpp")
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
# -mtune, not -march: the library must run on any x86-64 host the
# checkout moves to
CXX_FLAGS = ("-O3", "-mtune=native", "-std=c++17", "-shared", "-fPIC")

_lib = None
_lib_source = None
_lock = threading.Lock()


def library_path(source: Path) -> Path:
    h = hashlib.sha1(" ".join(CXX_FLAGS).encode())
    h.update(source.read_bytes())
    return BUILD_DIR / f"libketo_fastenc_{h.hexdigest()[:16]}.so"


def build(source: Path) -> Path:
    """Compile `source` unless its library exists. Raises RuntimeError
    with g++'s output when the compile fails."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "fastenc.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():  # another process built it while this one waited
            return out
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        try:
            proc = subprocess.run(["g++", *CXX_FLAGS, str(source), "-o", str(tmp)],
                                  capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed to build {source.name} ({proc.returncode}):\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
        finally:
            tmp.unlink(missing_ok=True)
    return out


def library() -> ctypes.CDLL:
    """The loaded library of SOURCE, built first if need be."""
    global _lib, _lib_source
    if _lib is not None and _lib_source == SOURCE:
        return _lib
    with _lock:
        if _lib is None or _lib_source != SOURCE:
            lib = ctypes.CDLL(str(build(SOURCE)))
            fn = lib.keto_unique_encode
            fn.restype = ctypes.c_int64
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                           ctypes.c_void_p, ctypes.c_void_p]
            bt = lib.keto_build_probe_table
            bt.restype = ctypes.c_int64
            bt.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                           ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                           ctypes.c_int32, ctypes.c_int64]
            _lib, _lib_source = lib, SOURCE
    return _lib


def unique_encode(keys: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(uniq_sorted, first_idx, codes) of a 1-D fixed-width bytes array:
    uniq_sorted == np.unique(keys), first_idx == np.unique(keys,
    return_index=True)[1] (int64), codes == np.searchsorted(uniq_sorted,
    keys) (int32)."""
    if keys.dtype.kind != "S" or keys.ndim != 1:
        raise TypeError(f"expected a 1-D S-dtype array, got {keys.dtype} of {keys.ndim} dims")
    n = len(keys)
    if n == 0:
        return keys.copy(), np.array([], np.int64), np.array([], np.int32)
    keys = np.ascontiguousarray(keys)
    first_idx = np.empty(n, dtype=np.int64)
    codes = np.empty(n, dtype=np.int32)
    n_uniq = library().keto_unique_encode(keys.ctypes.data, n, keys.dtype.itemsize,
                                          first_idx.ctypes.data, codes.ctypes.data)
    if n_uniq < 0:
        raise MemoryError(f"keto_unique_encode could not encode {n} keys "
                          "(past 2^30 rows, or out of memory)")
    first_idx = first_idx[:n_uniq]
    return keys[first_idx], first_idx, codes


sorted_unique_encode = unique_encode


def build_probe_table(h1: np.ndarray, h2: np.ndarray, keys: tuple[np.ndarray, ...],
                      values: np.ndarray, cap: int, empty: int, spb: int):
    """([key column arrays], value array, probe limit) of the round-based
    build into a table of `cap` slots, `spb` slots a bucket; the probe
    limit is -1 when a key needs more than 64 rounds (the caller grows
    cap and builds again)."""
    n = len(values)
    if any(len(k) != n for k in keys) or len(h1) != n or len(h2) != n:
        raise ValueError("build_probe_table: keys, values and hashes differ in length")
    key_block = np.ascontiguousarray(np.stack(keys) if keys else np.zeros((0, n)),
                                     dtype=np.int32)
    out_cols = np.full((len(keys), cap), empty, dtype=np.int32)
    out_vals = np.full(cap, empty, dtype=np.int32)
    h1 = np.ascontiguousarray(h1, dtype=np.uint32)
    h2 = np.ascontiguousarray(h2, dtype=np.uint32)
    values = np.ascontiguousarray(values, dtype=np.int32)
    rc = library().keto_build_probe_table(
        h1.ctypes.data, h2.ctypes.data, n, key_block.ctypes.data, len(keys),
        values.ctypes.data, out_cols.ctypes.data, out_vals.ctypes.data, cap, empty, spb,
    )
    if rc == -2:
        raise ValueError(f"keto_build_probe_table refused n={n}, cap={cap}, spb={spb} "
                         "(n past 2^30, spb not a power of two or past cap) or ran out of memory")
    return list(out_cols), out_vals, int(rc)
