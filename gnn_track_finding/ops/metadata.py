"""State-metadata pruning between iterations.

Re-design of src/update/remove_state_metadata.py:31-53: after extraction
removes nodes, state-dict entries keyed by vanished neighbours are dropped,
then priors and the mixture reweight are recomputed.  In the array model,
dict membership is carried by edge_mask (seed states) and has_updated
(updated states), so pruning is a mask intersection.
"""

from __future__ import annotations

from gnn_track_finding.config import PipelineConfig
from gnn_track_finding.graph.state import GraphState
from gnn_track_finding.ops import priors


def remove_state_metadata(g: GraphState, cfg: PipelineConfig) -> GraphState:
    g = g.replace(has_updated=g.has_updated & g.edge_mask)
    g = priors.compute_prior_probabilities(g, use_updated=False)
    # updated-prior recompute + reweight as ONE table-resident pass
    # (priors.reweight_stage n_passes=1): identical membership and
    # products to compute_prior_probabilities(use_updated=True) +
    # reweight, one scatter/gather cycle instead of three segment
    # passes plus the standalone (N, K, K) side-norm block.  The degree
    # refresh it carries
    # is the same value the next stage's update_degrees recomputes.
    g = priors.reweight_stage(g, cfg, n_passes=1)
    return g
