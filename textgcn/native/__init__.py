"""ctypes bindings for the native graph core (libgraphcore.so).

Built on demand with ``make`` (g++); every entry point has a pure-Python
fallback in :mod:`textgcn.graph.normalize` / ``build_textgcn``, so the
framework works without a toolchain — the native path is a host-side
performance feature, not a correctness dependency.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_LIB_PATH = os.path.join(_DIR, "libgraphcore.so")
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _ensure_built() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    if _lib is not None:
        return _lib
    if _build_failed:
        return None
    if not os.path.exists(_LIB_PATH) or os.path.getmtime(
        _LIB_PATH
    ) < os.path.getmtime(os.path.join(_DIR, "graphcore.cpp")):
        try:
            subprocess.run(
                ["make", "-s"],
                cwd=_DIR,
                check=True,
                capture_output=True,
                timeout=120,
            )
        except Exception:
            _build_failed = True
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        _build_failed = True
        return None

    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.tg_parse_edgelist.restype = ctypes.c_void_p
    lib.tg_parse_edgelist.argtypes = [ctypes.c_char_p, i64p]
    lib.tg_copy_edges.argtypes = [ctypes.c_void_p, i64p, i64p, f64p]
    lib.tg_free.argtypes = [ctypes.c_void_p]
    lib.tg_coalesce.restype = ctypes.c_void_p
    lib.tg_coalesce.argtypes = [
        i64p, i64p, f64p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, i64p,
    ]
    lib.tg_sym_normalize.restype = ctypes.c_void_p
    lib.tg_sym_normalize.argtypes = [
        i64p, i64p, f64p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, i64p,
    ]
    lib.tg_window_cooccurrence.restype = ctypes.c_void_p
    lib.tg_window_cooccurrence.argtypes = [
        i32p, i64p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        i64p, i64p, i64p,
    ]
    _lib = lib
    return lib


def available() -> bool:
    return _ensure_built() is not None


def _as_i64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int64)


def _as_f64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float64)


def _ptr(a: np.ndarray, t):
    return a.ctypes.data_as(t)


def _take(lib, handle, n: int):
    rows = np.empty(n, dtype=np.int64)
    cols = np.empty(n, dtype=np.int64)
    vals = np.empty(n, dtype=np.float64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.tg_copy_edges(handle, _ptr(rows, i64p), _ptr(cols, i64p), _ptr(vals, f64p))
    lib.tg_free(handle)
    return rows, cols, vals


def parse_edgelist(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    lib = _ensure_built()
    if lib is None:
        raise RuntimeError("native graphcore unavailable")
    n = ctypes.c_int64(0)
    handle = lib.tg_parse_edgelist(
        path.encode(), ctypes.byref(n)
    )
    if not handle:
        raise FileNotFoundError(path)
    return _take(lib, handle, n.value)


def coalesce(
    rows, cols, vals, n_nodes: int, reduce: str = "sum", symmetrize: bool = False
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    lib = _ensure_built()
    if lib is None:
        raise RuntimeError("native graphcore unavailable")
    rows, cols, vals = _as_i64(rows), _as_i64(cols), _as_f64(vals)
    n_out = ctypes.c_int64(0)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    handle = lib.tg_coalesce(
        _ptr(rows, i64p), _ptr(cols, i64p), _ptr(vals, f64p),
        len(rows), n_nodes, 1 if reduce == "max" else 0,
        1 if symmetrize else 0, ctypes.byref(n_out),
    )
    return _take(lib, handle, n_out.value)


def sym_normalize(
    rows, cols, vals, n_nodes: int, add_self_loops: bool = True
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    lib = _ensure_built()
    if lib is None:
        raise RuntimeError("native graphcore unavailable")
    rows, cols, vals = _as_i64(rows), _as_i64(cols), _as_f64(vals)
    n_out = ctypes.c_int64(0)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    handle = lib.tg_sym_normalize(
        _ptr(rows, i64p), _ptr(cols, i64p), _ptr(vals, f64p),
        len(rows), n_nodes, 1 if add_self_loops else 0, ctypes.byref(n_out),
    )
    return _take(lib, handle, n_out.value)


def window_cooccurrence(
    tokens: np.ndarray, offsets: np.ndarray, vocab: int, window: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, int]:
    """Returns (i, j, count, occ, n_windows) for unordered pairs i < j."""
    lib = _ensure_built()
    if lib is None:
        raise RuntimeError("native graphcore unavailable")
    tokens = np.ascontiguousarray(tokens, dtype=np.int32)
    offsets = _as_i64(offsets)
    occ = np.zeros(vocab, dtype=np.int64)
    n_windows = ctypes.c_int64(0)
    n_out = ctypes.c_int64(0)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    handle = lib.tg_window_cooccurrence(
        _ptr(tokens, i32p), _ptr(offsets, i64p), len(offsets) - 1,
        vocab, window, _ptr(occ, i64p), ctypes.byref(n_windows),
        ctypes.byref(n_out),
    )
    i, j, cnt = _take(lib, handle, n_out.value)
    return i, j, cnt, occ, n_windows.value
