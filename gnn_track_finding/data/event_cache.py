"""Binary event cache: parsed + order-resolved event arrays on disk.

The expensive parts of TrackML ingest are not the CSV parse (the C++
loader does that in ~0.2 s) but the NetworkX/CPython order emulation the
reference's numerics depend on — the set()-order mirror table and the
component labels (graph/build.py, graph/nxorder.py).  Both are pure
functions of the event files, so repeat streams of the same event can
skip them entirely: this module caches the raw arrays plus the two
derived products in one uncompressed .npz keyed by the source files'
identity (path, size, mtime) and the volume window.

The reference has no analog — it re-runs its full pandas/NetworkX ingest
(helper.py:524-581, event_conversion.py:15-123, ~97-220 s) every run.
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional

import numpy as np

CACHE_VERSION = 2


class LazyRagged:
    """Per-node ragged int lists backed by (flat, offsets) without
    materialising 55k+ Python slices up front.  Quacks like the
    list-of-arrays the evaluators index (len / [i] / iteration)."""

    __slots__ = ("flat", "off")

    def __init__(self, flat: np.ndarray, off: np.ndarray):
        self.flat = flat
        self.off = off

    def __len__(self) -> int:
        return len(self.off) - 1

    def __getitem__(self, i: int) -> np.ndarray:
        return self.flat[self.off[i]:self.off[i + 1]]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


def cache_key(nodes_csv: str, edges_csv: str, truth_csv: str,
              min_volume: int, max_volume: int) -> str:
    h = hashlib.sha1()
    h.update(f"v{CACHE_VERSION}|{min_volume}|{max_volume}".encode())
    for p in (nodes_csv, edges_csv, truth_csv):
        st = os.stat(p)
        h.update(f"|{p}|{st.st_size}|{st.st_mtime_ns}".encode())
    return h.hexdigest()[:16]


def _flatten(lists, dtype=np.int64):
    """List of per-node arrays -> (flat, offsets)."""
    if isinstance(lists, LazyRagged):
        return np.asarray(lists.flat, dtype), np.asarray(lists.off, np.int64)
    lens = np.fromiter((len(a) if a is not None else 0 for a in lists),
                       np.int64, len(lists))
    off = np.zeros(len(lists) + 1, np.int64)
    np.cumsum(lens, out=off[1:])
    flat = (np.concatenate([np.asarray(a, dtype) for a in lists
                            if a is not None and len(a)])
            if off[-1] else np.zeros(0, dtype))
    return flat, off


def _unflatten(flat, off):
    return [flat[off[i]:off[i + 1]] for i in range(len(off) - 1)]


def save(cache_dir: str, key: str, xyzr, vivl, truth_particle, pairs,
         extra: dict, mirror: np.ndarray, component: np.ndarray,
         slot_in: np.ndarray = None, slot_out: np.ndarray = None) -> str:
    """pairs must be DEDUPED (build_graph_state's kept set) when the slot
    tables are given: the slots index positions within that deduped edge
    list, and a cached load then skips the dedupe + both edge-table
    argsorts."""
    os.makedirs(cache_dir, exist_ok=True)
    hit_flat, hit_off = _flatten(extra["hit_ids"])
    pid_flat, _ = _flatten(extra["hit_particle_ids"])
    mod_flat, mod_off = _flatten(extra["module_ids"])
    path = os.path.join(cache_dir, f"event_{key}.npz")
    tmp = path + ".tmp"
    arrays = dict(xyzr=xyzr, vivl=vivl, truth_particle=truth_particle,
                  pairs=pairs, node_ids=np.asarray(extra["node_ids"]),
                  mirror=np.asarray(mirror), component=np.asarray(component),
                  hit_flat=hit_flat, hit_off=hit_off, pid_flat=pid_flat,
                  mod_flat=mod_flat, mod_off=mod_off)
    if slot_in is not None:
        arrays["slot_in"] = np.asarray(slot_in, np.uint16)
        arrays["slot_out"] = np.asarray(slot_out, np.uint16)
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)
    return path


def load(cache_dir: str, key: str) -> Optional[tuple]:
    """-> (xyzr, vivl, truth_particle, pairs, extra, precomputed) or None."""
    path = os.path.join(cache_dir, f"event_{key}.npz")
    if not os.path.exists(path):
        return None
    return read(path)


def read(path) -> tuple:
    """Arrays of one cache-format .npz (a path or an open binary file) ->
    (xyzr, vivl, truth_particle, pairs, extra, precomputed)."""
    z = np.load(path)
    extra = {
        "node_ids": z["node_ids"],
        "hit_ids": LazyRagged(z["hit_flat"], z["hit_off"]),
        "hit_particle_ids": LazyRagged(z["pid_flat"], z["hit_off"]),
        "module_ids": LazyRagged(z["mod_flat"], z["mod_off"]),
        "components": z["component"],
    }
    precomputed = {"mirror": z["mirror"], "component": z["component"]}
    if "slot_in" in z:
        precomputed["slot_in"] = z["slot_in"]
        precomputed["slot_out"] = z["slot_out"]
    return (z["xyzr"], z["vivl"], z["truth_particle"], z["pairs"],
            extra, precomputed)
