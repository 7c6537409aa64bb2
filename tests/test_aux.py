import os

import numpy as np
import networkx as nx
import pytest
import jax.numpy as jnp

from gnn_track_finding.config import PipelineConfig
from gnn_track_finding.graph import cca
from gnn_track_finding.graph.build import build_graph_state
from gnn_track_finding.models import toymc, pipeline
from gnn_track_finding.ops import metrics
from gnn_track_finding.utils import timing, checkpoint

CFG = PipelineConfig(node_bucket=64, edge_bucket=256)


def test_device_cca_matches_networkx_random_graphs():
    rng = np.random.default_rng(0)
    for trial in range(5):
        n = 40
        m = rng.integers(10, 60)
        pairs = rng.integers(0, n, size=(m, 2))
        pairs = pairs[pairs[:, 0] != pairs[:, 1]]
        src = jnp.asarray(np.concatenate([pairs[:, 0], pairs[:, 1]]).astype(np.int32))
        dst = jnp.asarray(np.concatenate([pairs[:, 1], pairs[:, 0]]).astype(np.int32))
        ok = jnp.ones(src.shape[0], bool)
        node_ok = jnp.ones(n, bool)
        labels = np.asarray(cca.connected_components(src, dst, ok, node_ok))

        G = nx.Graph()
        G.add_nodes_from(range(n))
        G.add_edges_from(pairs)
        for comp in nx.connected_components(G):
            lab = min(comp)
            for node in comp:
                assert labels[node] == lab, f"trial {trial} node {node}"


def test_confusion_metrics():
    ev = toymc.generate_event(seed=11, num_tracks=16, edge_dphi_window=0.12)
    g, _ = build_graph_state(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs, CFG)
    g = pipeline._prepare_jit(g, CFG)
    before = g
    g2 = pipeline.cluster_stage(g, CFG, use_updated=False)
    cm = metrics.edge_decision_confusion(before, g2)
    assert cm.tp + cm.fp + cm.tn + cm.fn == int(np.sum(
        np.asarray(before.edge_mask & before.active)))
    assert 0.0 <= cm.precision <= 1.0
    summ = metrics.graph_summary(g2)
    assert summ["merged_nodes"] > 0
    assert summ["active_edges"] <= summ["edges"]


def test_stage_timer_artifacts(tmp_path):
    t = timing.StageTimer()
    with t.stage("alpha"):
        pass
    with t.stage("beta"):
        pass
    d = t.durations()
    assert list(d.keys()) == ["alpha", "beta"]
    t.write_artifacts(str(tmp_path))
    stages = open(os.path.join(tmp_path, "execution_stages.txt")).read().split()
    assert stages == ["start_time", "alpha", "beta"]
    times = open(os.path.join(tmp_path, "execution_times.txt")).read().split()
    assert len(times) == 3


def test_checkpoint_roundtrip(tmp_path):
    ev = toymc.generate_event(seed=3, num_tracks=8)
    g, _ = build_graph_state(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs, CFG)
    g = pipeline._prepare_jit(g, CFG)
    out = pipeline.run_pipeline(g, CFG)
    checkpoint.save(str(tmp_path / "ckpt"), out.graph,
                    candidates=out.candidates, iteration=3)
    blank = build_graph_state(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs, CFG)[0]
    g2, cands = checkpoint.restore(str(tmp_path / "ckpt"), blank, iteration=3)
    np.testing.assert_array_equal(np.asarray(out.graph.node_mask),
                                  np.asarray(g2.node_mask))
    np.testing.assert_allclose(np.asarray(out.graph.merged_state),
                               np.asarray(g2.merged_state))
    assert len(cands) == len(out.candidates)
    for a, b in zip(cands, out.candidates):
        assert np.array_equal(a.nodes, b.nodes)
        assert a.iteration == b.iteration


def test_prefetch_preserves_order_and_values():
    """Double-buffered prefetch (data/prefetch.py) yields the same device
    states, in order, as sequential loading — including with a slow
    factory in the middle and depth > len(stream)."""
    from gnn_track_finding.data import prefetch as pf
    import time as _time

    def make(seed, slow=False):
        def factory():
            if slow:
                _time.sleep(0.05)
            ev = toymc.generate_event(seed=seed, num_tracks=6)
            return build_graph_state(ev.xyzr, ev.vivl, ev.truth,
                                     ev.edge_pairs, CFG)[0]
        return factory

    seeds = [1, 2, 3, 4]
    factories = [make(s, slow=(s == 2)) for s in seeds]
    got = list(pf.prefetch(factories, depth=2))
    assert len(got) == len(seeds)
    for s, g in zip(seeds, got):
        ref = make(s)()
        np.testing.assert_array_equal(np.asarray(g.xyzr),
                                      np.asarray(ref.xyzr))
        np.testing.assert_array_equal(np.asarray(g.src), np.asarray(ref.src))
    # depth larger than the stream, and depth=1 (no lookahead) both work
    assert len(list(pf.prefetch([make(7)], depth=8))) == 1
    assert len(list(pf.prefetch([make(7), make(8)], depth=1))) == 2


def test_prefetch_propagates_factory_error_in_position():
    from gnn_track_finding.data import prefetch as pf

    def boom():
        raise RuntimeError("ingest failed")

    def ok():
        ev = toymc.generate_event(seed=5, num_tracks=6)
        return build_graph_state(ev.xyzr, ev.vivl, ev.truth,
                                 ev.edge_pairs, CFG)[0]

    it = pf.prefetch([ok, boom, ok], depth=2)
    next(it)
    try:
        next(it)
        raised = False
    except RuntimeError:
        raised = True
    assert raised


def test_gather1d_oob_contract():
    """gather1d/gather1d_blocked clamp out-of-range indices to the
    endpoints (both the blocked multiple-of-64 path and the width-2
    fallback), matching plain x[idx]; onehot_select/table_lookup
    zero-fill out-of-range columns.  Pinned because the blocked form's
    floor-div/mod arithmetic would otherwise return an arbitrary
    in-range element."""
    import jax.numpy as jnp
    import numpy as np
    from gnn_track_finding.ops import gtools

    for n in (128, 96):          # blocked path / width-2 fallback
        x = jnp.arange(n, dtype=jnp.int32) * 3 + 1
        idx = jnp.asarray([-5, -1, 0, 1, n - 1, n, n + 7, 2 * n],
                          dtype=jnp.int32)
        got = np.asarray(gtools.gather1d(x, idx))
        want = np.asarray(x)[np.clip(np.asarray(idx), 0, n - 1)]
        assert np.array_equal(got, want), (n, got, want)

    rows = jnp.arange(12, dtype=jnp.int32).reshape(3, 4)
    col = jnp.asarray([-1, 4, 2], dtype=jnp.int32)
    got = np.asarray(gtools.onehot_select(rows, col))
    assert np.array_equal(got, [0, 0, 10])


@pytest.mark.parametrize("width", [3, 8])
def test_compact_rows_matches_python_oracle(width):
    """gtools.compact_rows moves each row's kept entries to the front in
    order (first `width` of them), zero-fills behind them, and copies values
    exactly: infinities in dropped slots never leak into kept ones."""
    from gnn_track_finding.ops import gtools

    rng = np.random.default_rng(7)
    keep = rng.random((6, 8)) < 0.5
    keep[0] = False                       # an empty row
    keep[1] = True                        # a full row, cut to width
    x = rng.normal(size=(6, 8, 3))
    x[~keep] = np.inf
    got, valid = gtools.compact_rows(jnp.asarray(keep), jnp.asarray(x), width)
    want = np.zeros((6, width, 3))
    for r in range(6):
        kept = x[r][keep[r]][:width]
        want[r, :len(kept)] = kept
        assert np.array_equal(np.asarray(valid[r]),
                              np.arange(width) < len(kept))
    assert np.array_equal(np.asarray(got), want)
