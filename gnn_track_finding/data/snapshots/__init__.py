"""Committed TrackML event snapshots, loaded by name.

Each snapshot is the binary event-cache form (data/event_cache.py) of one
TrackML event network, parsed and order-resolved once from the reference
checkout's CSVs: the "minCurv_0.3_134" network of event 1000 with its
full-mapping truth, restricted to a volume window.  The arrays travel with
the repository, so the main path needs no CSV and no reference checkout.

A snapshot is identified by the sha256 of its file, written below: a file
whose content differs is refused, never silently used.
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import os

_DIR = os.path.dirname(os.path.abspath(__file__))


@dataclasses.dataclass(frozen=True)
class Snapshot:
    file: str
    sha256: str
    min_volume: int
    max_volume: int
    description: str


SNAPSHOTS = {
    "trackml_full": Snapshot(
        "trackml_full.npz",
        "4f22cc08ea2cf1a46818a7a71fc6e0b836c552b2d848aa14eb3741ab545bf159",
        7, 14, "volumes 7-14: 55,701 nodes, 165,472 hit pairs"),
    "trackml_v7": Snapshot(
        "trackml_v7.npz",
        "6006e994947ec0b27ae6c5bd6add324bf263062469b15ff20f33639f9bcc928b",
        7, 7, "volume 7: 8,748 nodes, 7,383 hit pairs"),
}


def path(name: str) -> str:
    return os.path.join(_DIR, _lookup(name).file)


def _lookup(name: str) -> Snapshot:
    try:
        return SNAPSHOTS[name]
    except KeyError:
        raise KeyError(f"unknown snapshot {name!r}; known: "
                       f"{sorted(SNAPSHOTS)}") from None


def for_volumes(min_volume: int, max_volume: int) -> str:
    """Name of the snapshot that covers exactly this volume window."""
    for name, snap in SNAPSHOTS.items():
        if (snap.min_volume, snap.max_volume) == (min_volume, max_volume):
            return name
    raise KeyError(f"no snapshot covers volumes {min_volume}-{max_volume}; "
                   f"known: " + ", ".join(
                       f"{n} ({s.min_volume}-{s.max_volume})"
                       for n, s in SNAPSHOTS.items()))


def load_arrays(name: str) -> tuple:
    """-> (xyzr, vivl, truth_particle, pairs, extra, precomputed) of the
    named snapshot, after checking the file's sha256."""
    from gnn_track_finding.data import event_cache

    snap = _lookup(name)
    with open(path(name), "rb") as f:
        blob = f.read()
    digest = hashlib.sha256(blob).hexdigest()
    if digest != snap.sha256:
        raise ValueError(f"snapshot {name!r} ({snap.file}) has sha256 "
                         f"{digest}, expected {snap.sha256}")
    return event_cache.read(io.BytesIO(blob))


def load_event(name: str, cfg, dtype=None, with_tracker: bool = True):
    """-> (GraphState, HostEvent) of the named snapshot.

    cfg's volume window must be the snapshot's own: the arrays were cut to
    it when the snapshot was made."""
    import jax.numpy as jnp

    from gnn_track_finding.graph.build import build_graph_state

    snap = _lookup(name)
    if (cfg.min_volume, cfg.max_volume) != (snap.min_volume, snap.max_volume):
        raise ValueError(
            f"snapshot {name!r} holds volumes {snap.min_volume}-"
            f"{snap.max_volume}; the config asks for {cfg.min_volume}-"
            f"{cfg.max_volume}")
    if dtype is None:
        dtype = jnp.float64 if jnp.zeros(()).dtype == jnp.float64 else jnp.float32
    xyzr, vivl, truth_particle, pairs, extra, precomputed = load_arrays(name)
    return build_graph_state(xyzr, vivl, truth_particle, pairs, cfg,
                             dtype=dtype, host_extra=extra,
                             precomputed=precomputed,
                             with_tracker=with_tracker)
