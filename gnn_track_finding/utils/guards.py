"""Numerical failure detection.

The reference has no failure handling at all (SURVEY.md section 5: a
failed stage leaves its last gpickles; restart is manual).  Here the host
driver can cheaply audit the device state between iterations: NaN/Inf
incursions in the live state arrays, mask consistency, and degree-table
invariants.  One device reduction per field; raises or returns a report.
"""

from __future__ import annotations

from typing import Dict

import jax.numpy as jnp

from gnn_track_finding.graph.state import GraphState


def check_state(g: GraphState, strict: bool = False) -> Dict[str, bool]:
    """Returns {check: ok}; raises on failure when strict."""
    em = g.edge_mask
    checks = {
        "seed_sv_finite": bool(jnp.all(jnp.isfinite(
            jnp.where(em[:, None], g.seed_sv, 0.0)))),
        "seed_cov_finite": bool(jnp.all(jnp.isfinite(
            jnp.where(em[:, None, None], g.seed_cov, 0.0)))),
        "upd_sv_finite": bool(jnp.all(jnp.isfinite(
            jnp.where((g.has_updated & em)[:, None], g.upd_sv, 0.0)))),
        "merged_finite": bool(jnp.all(jnp.isfinite(
            jnp.where(g.has_merged[:, None], g.merged_state, 0.0)))),
        "weights_finite": bool(jnp.all(jnp.isfinite(
            jnp.where(em, g.seed_weight + g.upd_weight, 0.0)))),
        "active_subset_mask": bool(jnp.all(~g.active | g.edge_mask)),
        "edges_within_alive_nodes": bool(jnp.all(
            ~em | (g.node_mask[g.src] & g.node_mask[g.dst]))),
    }
    if strict:
        bad = [k for k, ok in checks.items() if not ok]
        if bad:
            raise FloatingPointError(f"graph state checks failed: {bad}")
    return checks
