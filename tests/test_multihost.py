import jax
import jax.numpy as jnp

from gnn_track_finding.config import PipelineConfig
from gnn_track_finding.graph.build import build_graph_state
from gnn_track_finding.models import toymc
from gnn_track_finding.parallel import multihost

CFG = PipelineConfig(node_bucket=64, edge_bucket=256)


def test_local_event_slice_single_process():
    lo, hi = multihost.local_event_slice(10)
    assert (lo, hi) == (0, 10)


def test_global_mesh_axes():
    m = multihost.global_mesh()
    assert set(m.axis_names) == {"data", "edge"}
    assert m.devices.size == len(jax.devices())


def test_scaling_report_dp_bar():
    """DP on the simulated mesh: the 4-events-over-4-devices batched
    program returns exactly the sum of the per-event sequential results,
    and the report carries both timings.  No wall-clock bar: the virtual
    CPU devices share this machine's cores with the other test workers,
    so their times say nothing about scaling; real multi-GPU runs are in
    chip_smoke.py --multi."""
    graphs = []
    for seed in range(4):
        ev = toymc.generate_event(num_tracks=6, seed=seed)
        g, _ = build_graph_state(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs,
                                 CFG, dtype=jnp.float32)
        graphs.append(g)
    rep = multihost.scaling_report(graphs, CFG)
    assert rep["events"] == 4 and rep["devices"] == 4
    assert rep["parallel_checksum"] == rep["sequential_checksum"]
    assert rep["sequential_checksum"] > 0
    assert rep["sequential_s"] > 0 and rep["parallel_s"] > 0
