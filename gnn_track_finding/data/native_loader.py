"""ctypes bindings for the native C++ event loader (native/loader.cc).

Replaces the pandas ingest hot path (reference helper.py:524-581 took
17-97 s on the TrackML event; see BASELINE.md) with a single-pass C++
parser + union-find.  The library is compiled from native/loader.cc into
build/native/ (git-ignored) at first use, and compiled again whenever the
source is newer than the library, so a library built elsewhere is never
loaded stale.  Without a C++ compiler the callers fall back to the pandas
parser (data/trackml.py) and the device CCA.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_REPO, "native", "loader.cc")
_LIB_PATH = os.path.join(_REPO, "build", "native", "libgnn_loader.so")

_lib = None


def available() -> bool:
    return _load() is not None


def _build() -> bool:
    """Compile the library when it is missing or older than its source."""
    if not os.path.exists(_SRC):
        return os.path.exists(_LIB_PATH)
    if (os.path.exists(_LIB_PATH)
            and os.path.getmtime(_LIB_PATH) >= os.path.getmtime(_SRC)):
        return True
    os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
    # compile to a private name, then rename: concurrent test workers may
    # build at once, and a reader must never see a half-written library
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    cmd = [os.environ.get("CXX", "g++"), "-O3", "-fPIC", "-std=c++17",
           "-shared", "-o", tmp, _SRC]
    try:
        done = subprocess.run(cmd, capture_output=True)
    except FileNotFoundError:        # no C++ compiler on this machine
        return False
    if done.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        return False
    os.replace(tmp, _LIB_PATH)
    return True


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not _build():
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    lib.gnn_load_event.restype = ctypes.c_void_p
    lib.gnn_load_event.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                   ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.gnn_error.restype = ctypes.c_char_p
    lib.gnn_error.argtypes = [ctypes.c_void_p]
    for name in ("gnn_num_nodes", "gnn_num_pairs", "gnn_num_hits",
                 "gnn_num_modules"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_void_p]
    lib.gnn_get_nodes.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 5
    lib.gnn_get_pairs.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.gnn_get_truth.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 5
    lib.gnn_free.argtypes = [ctypes.c_void_p]
    lib.gnn_cca.argtypes = [ctypes.c_int64, ctypes.c_int64] + [ctypes.c_void_p] * 4
    _lib = lib
    return lib


def load_event_arrays_native(nodes_csv: str, edges_csv: str, truth_csv: str,
                             min_volume: int, max_volume: int):
    """Same contract as trackml.load_event_arrays, via the C++ loader."""
    lib = _load()
    assert lib is not None, "native loader unavailable (no C++ compiler?)"
    h = lib.gnn_load_event(nodes_csv.encode(), edges_csv.encode(),
                           truth_csv.encode(), min_volume, max_volume)
    try:
        err = lib.gnn_error(h)
        if err:
            raise RuntimeError(f"native loader: {err.decode()}")
        n = lib.gnn_num_nodes(h)
        m = lib.gnn_num_pairs(h)
        n_hits = lib.gnn_num_hits(h)
        n_mods = lib.gnn_num_modules(h)

        xyzr = np.empty((n, 4), np.float64)
        vivl = np.empty((n, 2), np.int32)
        node_ids = np.empty(n, np.int64)
        comp = np.empty(n, np.int32)
        truth_pid = np.empty(n, np.int64)
        pairs = np.empty((m, 2), np.int32)
        hit_offsets = np.empty(n + 1, np.int64)
        hit_ids = np.empty(n_hits, np.int64)
        hit_pids = np.empty(n_hits, np.int64)
        mod_offsets = np.empty(n + 1, np.int64)
        mod_ids = np.empty(n_mods, np.int64)

        p = lambda a: a.ctypes.data_as(ctypes.c_void_p)
        lib.gnn_get_nodes(h, p(xyzr), p(vivl), p(node_ids), p(comp),
                          p(truth_pid))
        lib.gnn_get_pairs(h, p(pairs))
        lib.gnn_get_truth(h, p(hit_offsets), p(hit_ids), p(hit_pids),
                          p(mod_offsets), p(mod_ids))
    finally:
        lib.gnn_free(h)

    from gnn_track_finding.data.event_cache import LazyRagged
    extra = {"node_ids": node_ids,
             "hit_ids": LazyRagged(hit_ids, hit_offsets),
             "hit_particle_ids": LazyRagged(hit_pids, hit_offsets),
             "module_ids": LazyRagged(mod_ids, mod_offsets),
             "components": comp}
    return xyzr, vivl, truth_pid, pairs.astype(np.int64), extra


def connected_components_native(src: np.ndarray, dst: np.ndarray,
                                ok: np.ndarray, n: int) -> np.ndarray:
    """Union-find CCA over a masked directed edge list (min-id labels)."""
    lib = _load()
    assert lib is not None, "native loader unavailable (no C++ compiler?)"
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    ok = np.ascontiguousarray(ok, np.uint8)
    labels = np.empty(n, np.int32)
    p = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    lib.gnn_cca(n, len(src), p(src), p(dst), p(ok), p(labels))
    return labels
