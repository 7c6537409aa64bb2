"""Float32 exactness of the side-norm distinct-coordinate count.

Regression for the ADVICE round-1 medium finding: a side-offset composite
sort key (x + 4*xmax for the right side) quantizes x by ~eps*4*xmax in
float32 (~5e-4 at xmax~1000), collapsing near-but-distinct coordinates and
undercounting vs the reference's exact len(set(x)) semantics
(helper.py:127-134).  Distinctness must be counted on the raw values.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np

from gnn_track_finding.config import PipelineConfig
from gnn_track_finding.graph.build import build_graph_state
from gnn_track_finding.models import toymc
from gnn_track_finding.ops import priors


def test_side_norms_distinct_on_near_coordinates_f32():
    cfg = PipelineConfig(node_bucket=64, edge_bucket=256)
    ev = toymc.generate_event(num_tracks=6, seed=11)
    g, _ = build_graph_state(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs, cfg,
                             dtype=jnp.float32)

    # pick a node with >= 2 in-edges; give both updated states with snapshot
    # x on the RIGHT side of the node (the side the old code offset by
    # +4*xmax), differing by 2e-4 at magnitude ~900 (f32 resolution there is
    # ~6e-5, so the two values are distinct in f32 — but collapse once
    # shifted to ~4500 where resolution is ~5e-4)
    dst = np.asarray(g.dst)
    deg = np.bincount(dst[np.asarray(g.edge_mask)], minlength=g.num_padded_nodes)
    node = int(np.argmax(deg >= 2))
    edges = np.where((dst == node) & np.asarray(g.edge_mask))[0][:2]

    upd_xyzr = np.zeros((g.upd_xyzr.shape[0], 4), np.float32)
    x0 = np.float32(900.0)
    x1 = np.float32(900.0002)
    assert x0 != x1  # distinct in f32
    upd_xyzr[edges[0], 0] = x0
    upd_xyzr[edges[1], 0] = x1
    has_updated = np.zeros(g.upd_xyzr.shape[0], bool)
    has_updated[edges] = True
    gnn_xyzr = np.asarray(g.gnn_xyzr, np.float32).copy()
    gnn_xyzr[node, 0] = 800.0  # both senders on the right side

    g2 = dataclasses.replace(
        g,
        upd_xyzr=jnp.asarray(upd_xyzr),
        has_updated=jnp.asarray(has_updated),
        gnn_xyzr=jnp.asarray(gnn_xyzr),
        active=g.edge_mask,
    )
    norms = np.asarray(priors._side_norms(g2))
    assert norms[edges[0]] == 2.0, norms[edges]
    assert norms[edges[1]] == 2.0, norms[edges]
