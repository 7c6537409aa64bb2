import jax.numpy as jnp
import pytest

from gnn_track_finding.config import PipelineConfig
from gnn_track_finding.graph.build import build_graph_state
from gnn_track_finding.models import toymc, pipeline
from gnn_track_finding.utils import guards

CFG = PipelineConfig(node_bucket=64, edge_bucket=256)


def test_healthy_state_passes():
    ev = toymc.generate_event(seed=3, num_tracks=8)
    g, _ = build_graph_state(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs, CFG)
    out = pipeline.run_pipeline(g, CFG)
    checks = guards.check_state(out.graph, strict=True)
    assert all(checks.values())


def test_nan_detected():
    ev = toymc.generate_event(seed=3, num_tracks=8)
    g, _ = build_graph_state(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs, CFG)
    g = pipeline._prepare_jit(g, CFG)
    bad = g.replace(seed_sv=g.seed_sv.at[0, 0].set(jnp.nan))
    checks = guards.check_state(bad)
    assert not checks["seed_sv_finite"]
    with pytest.raises(FloatingPointError):
        guards.check_state(bad, strict=True)
