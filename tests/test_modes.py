import dataclasses

import numpy as np
import jax.numpy as jnp

from gnn_track_finding.config import PipelineConfig
from gnn_track_finding.graph.build import build_graph_state
from gnn_track_finding.models import toymc, pipeline
from gnn_track_finding.utils import guards

CFG = PipelineConfig(node_bucket=64, edge_bucket=256)


def test_clean_mode_runs_and_is_healthy():
    """bug_compat=False fixes the reference defects; the pipeline must
    still run end-to-end and produce a healthy state."""
    cfg = dataclasses.replace(CFG, bug_compat=False)
    ev = toymc.generate_event(seed=11, num_tracks=16, edge_dphi_window=0.12)
    g, _ = build_graph_state(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs, cfg)
    out = pipeline.run_pipeline(g, cfg)
    checks = guards.check_state(out.graph, strict=True)
    assert all(checks.values())
    # clean mode should still find candidates on this event
    assert len(out.candidates) > 0


def test_five_iteration_schedule():
    """The schedule generalises beyond 3 iterations: odd>1 cluster on
    updated states, even extrapolate (run_gnn_trackml_mod.sh:71-148)."""
    cfg = dataclasses.replace(CFG, num_iterations=5)
    ev = toymc.generate_event(seed=11, num_tracks=16, edge_dphi_window=0.12)
    g, _ = build_graph_state(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs, cfg)
    out = pipeline.run_pipeline(g, cfg)
    assert len(out.per_iteration) == 5
    checks = guards.check_state(out.graph, strict=True)
    assert all(checks.values())


def test_f32_pipeline_close_to_f64():
    ev = toymc.generate_event(seed=11, num_tracks=16, edge_dphi_window=0.12)
    g64, _ = build_graph_state(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs,
                               CFG, dtype=jnp.float64)
    g32, _ = build_graph_state(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs,
                               CFG, dtype=jnp.float32)
    out64 = pipeline.run_pipeline(g64, CFG)
    out32 = pipeline.run_pipeline(g32, CFG)
    s64 = {frozenset(map(int, c.nodes)) for c in out64.candidates}
    s32 = {frozenset(map(int, c.nodes)) for c in out32.candidates}
    # float32 may flip borderline chi2/p-value decisions, but the bulk of
    # the candidates must agree
    inter = len(s64 & s32)
    assert inter >= 0.8 * max(len(s64), 1), (len(s64), len(s32), inter)
