import numpy as np
import jax.numpy as jnp

from gnn_track_finding.config import PipelineConfig
from gnn_track_finding.graph import cca, tag_propagation
from gnn_track_finding.graph.build import build_graph_state
from gnn_track_finding.models import toymc

CFG = PipelineConfig(node_bucket=64, edge_bucket=256)


def build(seed=0, **kw):
    ev = toymc.generate_event(seed=seed, **kw)
    g, _ = build_graph_state(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs, CFG)
    return ev, g


def test_tags_respect_direction():
    """Inward-only propagation: a node's tag can only come from a node at
    smaller radius, so the innermost hit of each chain keeps its own tag."""
    ev, g = build(seed=3, num_tracks=6)
    tags = np.asarray(tag_propagation.propagate_tags(g, flip_fraction=0.0001))
    r = ev.xyzr[:, 3]
    src = np.asarray(g.src)[:g.n_edges]
    dst = np.asarray(g.dst)[:g.n_edges]
    for n in range(g.n_nodes):
        inward = [src[e] for e in range(g.n_edges)
                  if dst[e] == n and r[src[e]] < r[n]] + \
                 [dst[e] for e in range(g.n_edges)
                  if src[e] == n and r[dst[e]] < r[n]]
        if not inward:
            assert tags[n] == n    # no inward neighbours -> keeps own tag


def test_cca_variants_agree():
    ev, g = build(seed=7, num_tracks=10)
    ok = g.edge_mask
    a = cca.connected_components(g.src, g.dst, ok, g.node_mask)
    b = cca.connected_components_paired(g, ok)
    c = cca.connected_components_tables(g, ok)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(np.asarray(a), np.asarray(c))
