import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gnn_track_finding.config import PipelineConfig
from gnn_track_finding.graph.build import build_graph_state
from gnn_track_finding.models import toymc, pipeline
from gnn_track_finding.parallel import mesh as pmesh

CFG = PipelineConfig(node_bucket=64, edge_bucket=256)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_sharded_batched_pipeline_matches_single_device():
    graphs = []
    for seed in range(4):
        ev = toymc.generate_event(num_tracks=8, seed=seed)
        g, _ = build_graph_state(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs,
                                 CFG, dtype=jnp.float32)
        graphs.append(g)

    # single-device reference results
    singles = []
    for g in graphs:
        final, accepted, cand_nodes = pipeline.full_pipeline(g, CFG)
        singles.append((np.asarray(accepted), np.asarray(final.active)))

    # batched + sharded over a (2, 4) mesh
    m = pmesh.make_mesh(shape=(2, 4))
    batch = pmesh.stack_events(graphs)
    batch = pmesh.shard_batched_graph(batch, m)
    shardings = pmesh.batched_graph_sharding(batch, m)

    def step(graph):
        final, accepted, cand_nodes = jax.vmap(
            lambda gg: pipeline.full_pipeline(gg, CFG))(graph)
        return accepted, final.active

    step_jit = jax.jit(step, in_shardings=(shardings,))
    accepted_b, active_b = step_jit(batch)
    accepted_b = np.asarray(accepted_b)
    active_b = np.asarray(active_b)

    for i, (acc_s, act_s) in enumerate(singles):
        np.testing.assert_array_equal(accepted_b[i], acc_s,
                                      err_msg=f"event {i} accepted mismatch")
        np.testing.assert_array_equal(active_b[i], act_s,
                                      err_msg=f"event {i} active mismatch")
