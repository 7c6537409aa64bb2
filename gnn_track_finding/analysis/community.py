"""Community-detection track extraction (experimental alternative).

Re-design of src/extract/community_detection.py:16-94 — disabled in the
reference (extract_track_candidates.py:22).  The reference runs
leidenalg's ModularityVertexPartition (:16-50); igraph/leidenalg are not
in this image, so the default method is the from-scratch Leiden in
analysis/leiden.py (local move + refinement + aggregation, communities
guaranteed internally connected), with NetworkX Louvain as the
alternative.  Same candidate filters (fragment size, one hit per layer).
Gated off by default, matching the reference.
"""

from __future__ import annotations

from typing import List, Set

import numpy as np

from gnn_track_finding.config import PipelineConfig
from gnn_track_finding.graph.state import GraphState

COMMUNITY_DETECTION = False  # reference default (extract_track_candidates.py:22)


def detect_communities(g: GraphState, cfg: PipelineConfig,
                       seed: int = 0, method: str = "leiden"
                       ) -> List[Set[int]]:
    src = np.asarray(g.src)
    dst = np.asarray(g.dst)
    ok = np.asarray(g.edge_mask & g.active)
    w = np.asarray(g.upd_weight + g.seed_weight)
    alive = np.asarray(g.node_mask)

    pair_w = {}
    for e in np.flatnonzero(ok):
        u, v = int(src[e]), int(dst[e])
        key = (min(u, v), max(u, v))
        pair_w[key] = max(pair_w.get(key, 0.0), float(w[e]))

    if method == "leiden":
        from gnn_track_finding.analysis import leiden
        communities = leiden.leiden_communities(
            g.num_padded_nodes,
            [(u, v, wt) for (u, v), wt in pair_w.items()], seed=seed)
        communities = [c & set(map(int, np.flatnonzero(alive)))
                       for c in communities]
        communities = [c for c in communities if c]
    else:
        import networkx as nx
        G = nx.Graph()
        G.add_nodes_from(int(n) for n in np.flatnonzero(alive))
        for (u, v), wt in pair_w.items():
            G.add_edge(u, v, weight=wt)
        communities = nx.community.louvain_communities(G, weight="weight",
                                                       seed=seed)
    vivl = np.asarray(g.vivl)
    valid: List[Set[int]] = []
    for com in communities:
        nodes = set(int(n) for n in com)
        if len(nodes) < cfg.min_track_hits:
            continue  # fragment filter (community_detection.py:52-66)
        layers = [(int(vivl[n, 0]), int(vivl[n, 1])) for n in nodes]
        if len(layers) != len(set(layers)):
            continue  # one hit per layer (community_detection.py:68-86)
        valid.append(nodes)
    return valid
