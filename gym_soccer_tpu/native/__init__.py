"""Native (C++) host components, loaded via ctypes with transparent
build-on-first-use and pure-Python fallbacks.

The device compute path is JAX/XLA/Pallas; these cover host-side work the
Python interpreter is slow at:

* ``mt19937_streams`` — threaded batched MT19937 parity stream generator
  (used by gym_soccer_tpu/core/parity.py);
* ``build_tables_arrays`` — threaded transition-table builder filling the
  exact padded tensors of core/tables.py byte-for-byte (used by
  ``core.tables.build_tables``; the numpy path is the fallback and the
  cross-check oracle).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_lock = threading.Lock()
_libs: dict[str, object] = {}


def _load(name: str, configure) -> object | None:
    """Build (if stale) + dlopen ``name``.cc, configure its prototypes via
    ``configure(lib)``.  Returns the library or None; result is cached
    (including failure) so each build is attempted once per process."""
    with _lock:
        if name in _libs:
            return _libs[name]
        _libs[name] = None
        src = os.path.join(_HERE, f"{name}.cc")
        so = os.path.join(_HERE, f"_{name}.so")
        if not os.path.exists(so) or (
                os.path.getmtime(so) < os.path.getmtime(src)):
            # Compile to a process-unique temp path and rename into place:
            # os.rename is atomic, so concurrent processes racing on
            # build-on-first-use each dlopen a fully-written library.
            tmp = f"{so}.{os.getpid()}.tmp"
            try:
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", "-pthread", src,
                     "-o", tmp],
                    check=True, capture_output=True, timeout=180)
                os.rename(tmp, so)
            except Exception:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                return None
        try:
            lib = ctypes.CDLL(so)
            configure(lib)
            _libs[name] = lib
        except (OSError, AttributeError):
            # unreadable library, or a stale/foreign .so lacking the
            # expected symbols — fall back transparently
            pass
        return _libs[name]


def _cfg_mt19937(lib):
    lib.mt19937_gen_streams.argtypes = [
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_double), ctypes.c_int]
    lib.mt19937_gen_streams.restype = None


def _cfg_tables(lib):
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.soccer_build_tables.argtypes = [
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        f64p, ctypes.c_int64, i32p, i32p, u8p, f64p,
        f64p, f64p, i32p, i32p, f64p, u8p, u8p, i32p, ctypes.c_int32]
    lib.soccer_build_tables.restype = None


def _default_threads() -> int:
    # oversubscribe a little: bursty/stolen vCPUs (common on shared
    # hosts) schedule better with more runnable threads
    return min(2 * (os.cpu_count() or 1), 16)


def have_native() -> bool:
    return _load("mt19937_stream", _cfg_mt19937) is not None


def have_native_tables() -> bool:
    return _load("tables_builder", _cfg_tables) is not None


def mt19937_streams(seeds, n_draws: int,
                    n_threads: int | None = None) -> np.ndarray | None:
    """[B, n_draws] float64 streams identical to numpy's
    RandomState(seed).random_sample(n_draws) per row, or None if the
    native library is unavailable (callers fall back to numpy)."""
    lib = _load("mt19937_stream", _cfg_mt19937)
    if lib is None:
        return None
    seeds = np.ascontiguousarray(np.asarray(seeds, dtype=np.uint64))
    out = np.empty((len(seeds), n_draws), dtype=np.float64)
    lib.mt19937_gen_streams(
        seeds.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        len(seeds), n_draws,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        int(n_threads if n_threads is not None else _default_threads()))
    return out


def build_tables_arrays(W: int, H: int, gr_lo: int, gr_hi: int,
                        combo_probs, dense_to_raw, raw_to_dense,
                        goal_mask_raw, goal_reward_raw,
                        n_threads: int | None = None) -> dict | None:
    """Fill the padded transition tensors (see core/tables.GameTables) for
    the given state space; byte-identical to the numpy builder.  Returns a
    dict of arrays, or None if the native library is unavailable."""
    lib = _load("tables_builder", _cfg_tables)
    if lib is None:
        return None
    mp = np.ascontiguousarray(np.asarray(combo_probs, np.float64))
    d2r = np.ascontiguousarray(np.asarray(dense_to_raw, np.int32))
    r2d = np.ascontiguousarray(np.asarray(raw_to_dense, np.int32))
    gmask = np.ascontiguousarray(
        np.asarray(goal_mask_raw, bool).view(np.uint8))
    grew = np.ascontiguousarray(np.asarray(goal_reward_raw, np.float64))
    nS = int(d2r.shape[0])
    assert mp.shape == (9,) and r2d.shape == gmask.shape == grew.shape

    shape = (nS, 25, 36)
    out = {
        "t_prob": np.empty(shape, np.float64),
        "t_cum": np.empty(shape, np.float64),
        "t_next_raw": np.empty(shape, np.int32),
        "t_next_dense": np.empty(shape, np.int32),
        "t_reward": np.empty(shape, np.float64),
        "t_done": np.empty(shape, bool),
        "t_mask": np.empty(shape, bool),
        "t_first": np.empty((nS, 25), np.int32),
    }

    def ptr(a, ct):
        return a.ctypes.data_as(ctypes.POINTER(ct))

    lib.soccer_build_tables(
        int(W), int(H), int(gr_lo), int(gr_hi),
        ptr(mp, ctypes.c_double), nS,
        ptr(d2r, ctypes.c_int32), ptr(r2d, ctypes.c_int32),
        ptr(gmask, ctypes.c_uint8), ptr(grew, ctypes.c_double),
        ptr(out["t_prob"], ctypes.c_double),
        ptr(out["t_cum"], ctypes.c_double),
        ptr(out["t_next_raw"], ctypes.c_int32),
        ptr(out["t_next_dense"], ctypes.c_int32),
        ptr(out["t_reward"], ctypes.c_double),
        ptr(out["t_done"].view(np.uint8), ctypes.c_uint8),
        ptr(out["t_mask"].view(np.uint8), ctypes.c_uint8),
        ptr(out["t_first"], ctypes.c_int32),
        int(n_threads if n_threads is not None else _default_threads()))
    return out
