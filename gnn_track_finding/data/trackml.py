"""TrackML event ingest.

Replaces the reference's pandas loaders (helper.py:524-581,
event_conversion.py:50-56) with direct array construction:

  * nodes CSV ``node_idx,layer_id,x,y,z`` filtered to the volume range,
    r = hypot(x, y), volume_id = layer_id // 1000,
    in_volume_layer_id = layer_id % 100 (helper.py:15-19,529-534);
  * edges CSV whose FIRST line is a ``<nodes> <edges>`` count header
    followed by the real ``node2,node1,weight`` header (helper.py:536-543);
  * the aggregated truth mapping ``node_idx,hit_id,particle_id,volume_id,
    layer_id,module_id,nhits`` — the artifact load_save_truth writes
    (helper.py:548-581) and the pipeline re-reads (event_conversion.py:56).

Node-level truth follows construct_graph (helper.py:469-508): the per-node
particle id is the FIRST unique particle id among its hits in file order;
the full hit/particle dissociation and module lists ride along host-side
for evaluation.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from gnn_track_finding.config import PipelineConfig
from gnn_track_finding.graph.build import build_graph_state


@dataclasses.dataclass
class TrackMLPaths:
    nodes_csv: str
    edges_csv: str
    truth_csv: str           # aggregated full-mapping CSV
    particles_csv: Optional[str] = None


def load_event_arrays(paths: TrackMLPaths, cfg: PipelineConfig):
    import pandas as pd     # CSV path only: pandas is an optional dependency
    lo = cfg.min_volume * 1000
    hi = (cfg.max_volume + 1) * 1000

    nodes = pd.read_csv(paths.nodes_csv)
    nodes = nodes.loc[nodes["layer_id"].between(lo, hi)].reset_index(drop=True)
    node_ids = nodes["node_idx"].to_numpy(np.int64)
    x = nodes["x"].to_numpy(float)
    y = nodes["y"].to_numpy(float)
    z = nodes["z"].to_numpy(float)
    r = np.hypot(x, y)
    xyzr = np.stack([x, y, z, r], axis=1)
    layer_id = nodes["layer_id"].to_numpy(np.int64)
    vivl = np.stack([layer_id // 1000, layer_id % 100], axis=1).astype(np.int32)

    # dense node re-indexing
    remap = {int(n): i for i, n in enumerate(node_ids)}

    # edges: first line is a count header (helper.py:536-543)
    edges = pd.read_csv(paths.edges_csv, skiprows=1)
    e1 = edges["node1"].to_numpy(np.int64)
    e2 = edges["node2"].to_numpy(np.int64)
    keep = np.array([a in remap and b in remap for a, b in zip(e1, e2)])
    pairs = np.stack([[remap[int(a)] for a in e1[keep]],
                      [remap[int(b)] for b in e2[keep]]], axis=1)

    # truth mapping
    truth = pd.read_csv(paths.truth_csv)
    truth_particle = np.full(len(node_ids), -1, np.int64)
    hit_ids, hit_pids, module_ids = ([None] * len(node_ids) for _ in range(3))
    for nid, grp in truth.groupby("node_idx", sort=False):
        i = remap.get(int(nid))
        if i is None:
            continue
        pids = grp["particle_id"].to_numpy(np.int64)
        uniq = pd.unique(pids)
        truth_particle[i] = uniq[0]          # first unique (helper.py:472)
        hit_ids[i] = grp["hit_id"].to_numpy(np.int64)
        hit_pids[i] = pids
        module_ids[i] = pd.unique(grp["module_id"].to_numpy(np.int64))

    extra = {"node_ids": node_ids, "hit_ids": hit_ids,
             "hit_particle_ids": hit_pids, "module_ids": module_ids}
    return xyzr, vivl, truth_particle, pairs, extra


def load_event(event, cfg: PipelineConfig, dtype=None,
               use_native: bool = True, cache_dir: str = None,
               with_tracker: bool = True):
    """-> (GraphState, HostEvent) for one TrackML event.

    event: the name of a committed snapshot (data/snapshots, e.g.
    "trackml_full") or the TrackMLPaths of user-supplied CSVs.

    CSVs are parsed by the C++ loader (native/loader.cc, ~40x faster than
    the pandas path with byte-identical arrays) when it builds.

    cache_dir: binary event cache for CSV events (data/event_cache.py) —
    repeat loads of the same files skip the parse AND the NetworkX-order
    emulation (mirror table, components).  with_tracker=False skips the
    RefOrderTracker (only the bug-compat extraction-leak replay needs it)
    — the fast streaming mode.
    """
    if isinstance(event, str):
        from gnn_track_finding.data import snapshots
        return snapshots.load_event(event, cfg, dtype=dtype,
                                    with_tracker=with_tracker)
    paths = event
    import jax.numpy as jnp
    if dtype is None:
        dtype = jnp.float64 if jnp.zeros(()).dtype == jnp.float64 else jnp.float32
    from gnn_track_finding.data import native_loader

    precomputed = None
    key = None
    if cache_dir is not None:
        from gnn_track_finding.data import event_cache
        key = event_cache.cache_key(paths.nodes_csv, paths.edges_csv,
                                    paths.truth_csv, cfg.min_volume,
                                    cfg.max_volume)
        hit = event_cache.load(cache_dir, key)
        if hit is not None:
            xyzr, vivl, truth_particle, pairs, extra, precomputed = hit
            return build_graph_state(xyzr, vivl, truth_particle, pairs, cfg,
                                     dtype=dtype, host_extra=extra,
                                     precomputed=precomputed,
                                     with_tracker=with_tracker)

    if use_native and native_loader.available():
        xyzr, vivl, truth_particle, pairs, extra = (
            native_loader.load_event_arrays_native(
                paths.nodes_csv, paths.edges_csv, paths.truth_csv,
                cfg.min_volume, cfg.max_volume))
    else:
        xyzr, vivl, truth_particle, pairs, extra = load_event_arrays(paths, cfg)
    g, host = build_graph_state(xyzr, vivl, truth_particle, pairs, cfg,
                                dtype=dtype, host_extra=extra,
                                with_tracker=with_tracker)
    if cache_dir is not None and (cfg.bug_compat or with_tracker):
        # clean mode without a tracker skips the mirror computation
        # (identity placeholder) — never cache that, or a later
        # bug-compat load of the same files would read a wrong mirror
        import numpy as _np
        from gnn_track_finding.data import event_cache
        e = g.n_edges
        # store the DEDUPED pair list the slot tables index (cache
        # contract, event_cache.save) — reconstructed from the interleaved
        # directed edges (2i = u->v)
        src_np = _np.asarray(g.src)[:e]
        dst_np = _np.asarray(g.dst)[:e]
        deduped = _np.stack([src_np[0::2], dst_np[0::2]], axis=1)
        event_cache.save(cache_dir, key, xyzr, vivl, truth_particle,
                         deduped.astype(pairs.dtype), extra,
                         host.mirror[:e],
                         _np.asarray(g.component)[:xyzr.shape[0]],
                         slot_in=_np.asarray(g.slot_in)[:e],
                         slot_out=_np.asarray(g.slot_out)[:e])
    return g, host


def reference_event(root: str) -> TrackMLPaths:
    """CSVs of the event the committed snapshots were made from, inside a
    checkout of the reference repository at `root`: the minCurv_0.3_134
    network of event 1000, its full-mapping truth and particle table."""
    import os
    base = os.path.join(root, "src", "trackml_mod")
    net = os.path.join(base, "event_network", "minCurv_0.3_134")
    truth = os.path.join(base, "event_truth")
    return TrackMLPaths(
        nodes_csv=os.path.join(net, "event_1_filtered_graph_nodes.csv"),
        edges_csv=os.path.join(net, "event_1_filtered_graph_edges.csv"),
        truth_csv=os.path.join(
            truth, "event000001000-full-mapping-minCurv-0.3-800.csv"),
        particles_csv=os.path.join(truth, "event000001000-particles.csv"))
