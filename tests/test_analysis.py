import numpy as np

from gnn_track_finding.config import PipelineConfig
from gnn_track_finding.graph.build import build_graph_state
from gnn_track_finding.models import toymc, pipeline
from gnn_track_finding.analysis import (community, distributions, pulls,
                                            remaining, state_distances)

CFG = PipelineConfig(node_bucket=64, edge_bucket=256)


def pipeline_result():
    ev = toymc.generate_event(seed=11, num_tracks=16, edge_dphi_window=0.12)
    g, _ = build_graph_state(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs, CFG)
    out = pipeline.run_pipeline(g, CFG)
    return ev, g, out


def test_pull_residuals():
    ev, g, out = pipeline_result()
    g_seeded = pipeline._prepare_jit(g, CFG)
    res = pulls.pull_residuals(g_seeded, CFG)
    n = len(res["pull_a"])
    assert n > 0
    for k in ("pull_b", "pull_c", "pull_tau", "pull_theta1", "pull_theta2",
              "truth"):
        assert len(res[k]) == n
    # true-pair pulls of the direction parameter should be near unit-ish
    true_b = res["pull_b"][res["truth"] == 1]
    assert np.isfinite(true_b).all()
    w = pulls.fwhm(true_b)
    assert np.isfinite(w) and w > 0


def test_remaining_and_coverage():
    ev, g, out = pipeline_result()
    stats = remaining.analyse_remaining(out.graph)
    assert stats.get("remaining_components", 0) >= 0
    cov = remaining.updated_state_coverage(out.graph)
    assert 0.0 <= cov["fraction"] <= 1.0


def test_updated_state_distances():
    ev, g, out = pipeline_result()
    # state after iteration 2 holds updated states
    g1 = pipeline._prepare_jit(g, CFG)
    g1, _ = pipeline._iteration_jit(g1, CFG, 1, None)
    g2, _ = pipeline._iteration_jit(g1, CFG, 2, None)
    d = state_distances.updated_state_distances(g2, CFG)
    assert len(d["chi2"]) == len(d["kl"]) == len(d["truth"])


def test_community_detection_runs():
    ev, g, out = pipeline_result()
    coms = community.detect_communities(out.graph, CFG)
    for c in coms:
        assert len(c) >= CFG.min_track_hits


def test_distribution_artifacts(tmp_path):
    ev, g, out = pipeline_result()
    distributions.save_pvals_csv(out.candidates, str(tmp_path / "pvals.csv"))
    assert (tmp_path / "pvals.csv").exists()
    distributions.plot_pval_distributions(out.candidates, str(tmp_path))
    assert (tmp_path / "p_value_distribution_xy.png").exists()
    distributions.plot_candidates_xy_zr(g, out.candidates, str(tmp_path))
    assert (tmp_path / "subgraphs_xy.png").exists()
    assert (tmp_path / "subgraphs_zr.png").exists()


def test_average_linkage_matches_scipy():
    """Pin the self-contained average-linkage maximum against
    scipy.cluster.hierarchy.linkage (the reference study's sch.linkage,
    weight_v_angle_dist_stats.py:124-126)."""
    import scipy.cluster.hierarchy as sch
    from gnn_track_finding.analysis import shared_hits
    rng = np.random.default_rng(0)
    for m in (2, 3, 5, 9, 16):
        feats = rng.normal(size=(m, 2))
        z = sch.linkage(feats, method="average")
        np.testing.assert_allclose(
            shared_hits.average_linkage_max_distance(feats),
            float(np.amax(z[:, 2])), rtol=1e-10)


def test_dendrogram_statistics():
    """The shared-hit dendrogram repetition study
    (run_dendograms_statistics.sh:4-12) produces finite maxima for both
    iterations."""
    from gnn_track_finding.analysis import shared_hits
    res = shared_hits.dendrogram_statistics(
        num_runs=2, seed=11, cfg=CFG, num_tracks=16,
        toy_kwargs={"edge_dphi_window": 0.12})
    assert res["iteration1"].size > 0
    assert np.isfinite(res["iteration1"]).all()
    assert (res["iteration1"] >= 0).all()
    # iteration-2 sample exists when updated states survive
    assert np.isfinite(res["iteration2"]).all()


def test_quality_check_extracted_candidates():
    """The candidate audit (quality_check_extracted_candidates.py:47-129):
    every accepted candidate passes all four structural invariants on the
    toy workload, and a planted fragment fails test 1."""
    from gnn_track_finding.analysis import quality_check
    ev = toymc.generate_event(seed=11, num_tracks=16, edge_dphi_window=0.12)
    g, _ = build_graph_state(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs, CFG)
    out = pipeline.run_pipeline(g, CFG)
    assert out.candidates, "no candidates — audit is vacuous"
    audits = quality_check.quality_check_candidates(
        [c.nodes for c in out.candidates], ev.xyzr, ev.vivl,
        np.asarray(g.src), np.asarray(g.dst), np.asarray(g.edge_mask),
        min_track_hits=CFG.min_track_hits)
    summary = quality_check.summarize(audits)
    assert summary["n_candidates"] == len(out.candidates)
    assert summary["fragments"] == 0
    assert summary["layer_holes"] == 0
    # accepted candidates are r-ordered connected chains by construction
    assert summary["r_order_breaks"] == 0

    # planted defect: a 2-hit fragment of disconnected nodes fails
    iso = np.array([0, int(np.asarray(g.n_nodes)) - 1])
    bad = quality_check.quality_check_candidates(
        [iso], ev.xyzr, ev.vivl, np.asarray(g.src), np.asarray(g.dst),
        np.zeros_like(np.asarray(g.edge_mask)),
        min_track_hits=CFG.min_track_hits)
    assert not bad[0].min_hits_ok
    assert not bad[0].r_order_connected


def test_close_proximity_separations():
    """r&d/remaining/close_proximity_module_hits.py analog: a remaining
    component with one doubled layer whose pair shares a common
    neighbour yields its 3D separation and the percentile cut."""
    from gnn_track_finding.analysis import remaining as rem

    # two parallel tracks merged at one layer: layer 2 holds two hits
    # that both connect to the layer-1 hit (common neighbour)
    n = 8
    xyzr = np.zeros((n, 4))
    xyzr[:, 0] = [1, 2, 2, 3, 4, 5, 6, 7]
    xyzr[:, 1] = [0, 0.5, -0.5, 0, 0, 0, 0, 0]
    xyzr[:, 3] = np.sqrt(xyzr[:, 0] ** 2 + xyzr[:, 1] ** 2)
    vivl = np.stack([np.full(n, 7),
                     np.array([1, 2, 2, 3, 4, 5, 6, 7])], axis=1)
    pairs = np.array([(0, 1), (0, 2), (1, 3), (2, 3), (3, 4), (4, 5),
                      (5, 6), (6, 7)])
    cfg = PipelineConfig(node_bucket=64, edge_bucket=256)
    g, _ = build_graph_state(xyzr, vivl, np.arange(n), pairs, cfg)
    out = rem.close_proximity_separations(g)
    assert out["extractable_components"] == 1
    np.testing.assert_allclose(out["separations"], [1.0])
    np.testing.assert_allclose(out["separation_cut"], 1.0)

    # fragments (<=4 nodes) are skipped (:60)
    g2, _ = build_graph_state(xyzr[:4], vivl[:4], np.arange(4),
                              np.array([(0, 1), (0, 2), (1, 3), (2, 3)]),
                              cfg)
    out2 = rem.close_proximity_separations(g2)
    assert out2["extractable_components"] == 0


def test_node_weight_distributions_and_remaining_plots(tmp_path):
    """r&d/node_weight_dist/test_weight_dist.py +
    r&d/remaining/plot_remaining_subgraphs.py analogs on a pipeline-run
    toy event."""
    from gnn_track_finding.analysis import remaining as rem
    from gnn_track_finding.analysis import distributions
    from gnn_track_finding.models import pipeline

    ev = toymc.generate_event(seed=11, num_tracks=16)
    cfg = PipelineConfig(node_bucket=64, edge_bucket=256)
    g, _ = build_graph_state(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs, cfg)
    out = pipeline.run_pipeline(g, cfg)
    assert out.candidates, "vacuous: no candidates"

    dists = rem.node_weight_distributions(out.graph, out.candidates)
    assert len(dists) == len(out.candidates)
    # candidate nodes were REMOVED from the graph by extraction, so their
    # in-edge lists are empty in the final state; run against the
    # pre-extraction state for a non-vacuous check
    g1 = pipeline._prepare_jit(g, cfg)
    g1 = pipeline._stage_jit(g1, cfg, 1, None)
    d1 = rem.node_weight_distributions(g1, out.candidates)
    n_weights = sum(w.size for per in d1.values() for w in per.values())
    assert n_weights > 0
    for per in d1.values():
        for w in per.values():
            assert ((w >= 0) & (w <= 1 + 1e-9)).all()

    n_plots = distributions.plot_remaining_subgraphs(
        out.graph, str(tmp_path), max_plots=3)
    assert 1 <= n_plots <= 3
    import os
    assert any(f.endswith(".png") for f in os.listdir(tmp_path))


def test_leiden_planted_partition():
    """From-scratch Leiden (analysis/leiden.py, the reference's actual
    algorithm — community_detection.py:16-50 uses leidenalg): recovers a
    planted two-community graph, every community is internally CONNECTED
    (the Leiden guarantee Louvain lacks), deterministic per seed, and
    modularity is computed correctly."""
    import networkx as nx
    from gnn_track_finding.analysis import leiden

    rng = np.random.default_rng(3)
    n = 24
    edges = []
    for a, b in ((0, 12), (12, 24)):          # two dense blocks
        for i in range(a, b):
            for j in range(i + 1, b):
                if rng.random() < 0.6:
                    edges.append((i, j, 1.0))
    edges.append((3, 15, 1.0))                 # one weak bridge

    comms = leiden.leiden_communities(n, edges, seed=0)
    comms = [c for c in comms if len(c) > 1]
    assert len(comms) == 2
    assert sorted(map(sorted, comms)) == [list(range(12)),
                                          list(range(12, 24))]
    # determinism
    comms2 = leiden.leiden_communities(n, edges, seed=0)
    assert sorted(map(sorted, (c for c in comms2 if len(c) > 1))) == \
        sorted(map(sorted, comms))

    q = leiden.modularity(n, edges, {u: (0 if u < 12 else 1)
                                     for u in range(n)})
    G = nx.Graph()
    G.add_weighted_edges_from(edges)
    q_nx = nx.community.modularity(G, [set(range(12)), set(range(12, 24))],
                                   weight="weight")
    np.testing.assert_allclose(q, q_nx, rtol=1e-9)

    # connectivity guarantee on a noisy random graph
    m = 40
    edges2 = [(int(a), int(b), 1.0)
              for a, b in rng.integers(0, m, (120, 2)) if a != b]
    comms3 = leiden.leiden_communities(m, edges2, seed=1)
    G2 = nx.Graph()
    G2.add_nodes_from(range(m))
    G2.add_weighted_edges_from(edges2)
    for c in comms3:
        if len(c) > 1:
            assert nx.is_connected(G2.subgraph(c)), c


def test_detect_communities_leiden_extraction():
    """Leiden-backed community extraction applies the reference's
    fragment and one-hit-per-layer filters (community_detection.py:52-86)
    on a pipeline-staged toy event."""
    ev = toymc.generate_event(seed=11, num_tracks=16)
    g, _ = build_graph_state(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs, CFG)
    g = pipeline._prepare_jit(g, CFG)
    g = pipeline._stage_jit(g, CFG, 1, None)
    cands = community.detect_communities(g, CFG, method="leiden")
    assert cands, "vacuous: no communities survive the filters"
    vivl = np.asarray(g.vivl)
    for c in cands:
        assert len(c) >= CFG.min_track_hits
        layers = [(int(vivl[n, 0]), int(vivl[n, 1])) for n in c]
        assert len(layers) == len(set(layers))


def test_leiden_adversarial_properties():
    """Round-5 hardening: on randomized dense mixed-neighbourhood graphs
    (planted blocks + heavy noise) across seeds, (a) NO community is ever
    internally disconnected (the Leiden guarantee, now also enforced by a
    final split), and (b) iterated Leiden's modularity is competitive
    with NetworkX Louvain: never worse by more than 0.02 on any graph and
    at least as good in aggregate (per-run strict dominance over a
    differently-randomized Louvain is not a property of either
    algorithm)."""
    import networkx as nx
    from gnn_track_finding.analysis import leiden

    rng = np.random.default_rng(17)
    diffs = []
    for trial in range(8):
        n = int(rng.integers(24, 48))
        # planted blocks
        blocks = np.array_split(np.arange(n), 3)
        G = nx.Graph()
        G.add_nodes_from(range(n))
        for blk in blocks:
            for i in blk:
                for j in blk:
                    if i < j and rng.random() < 0.7:
                        G.add_edge(int(i), int(j))
        # dense mixed noise between blocks
        for _ in range(2 * n):
            u, v = rng.integers(0, n, 2)
            if u != v:
                G.add_edge(int(u), int(v))
        edges = [(u, v, 1.0) for u, v in G.edges()]
        for seed in (0, 1, 2):
            comms = leiden.leiden_communities(n, edges, seed=seed)
            assert sorted(u for c in comms for u in c) == list(range(n))
            for c in comms:
                if len(c) > 1:
                    assert nx.is_connected(G.subgraph(c)), (trial, seed, c)
        memb = {}
        for i, c in enumerate(leiden.leiden_communities(n, edges,
                                                        seed=trial)):
            for u in c:
                memb[u] = i
        q_leiden = leiden.modularity(n, edges, memb)
        louv = nx.community.louvain_communities(G, seed=trial)
        membL = {}
        for i, c in enumerate(louv):
            for u in c:
                membL[u] = i
        q_louv = leiden.modularity(n, edges, membL)
        assert q_leiden >= q_louv - 0.02, (trial, q_leiden, q_louv)
        diffs.append(q_leiden - q_louv)
    assert float(np.mean(diffs)) >= -1e-9, diffs


def test_leiden_extraction_filter_stability():
    """The community-extraction filter output (fragment + one-hit-per-
    layer, community_detection.py:52-86) is stable across Leiden seeds on
    a pipeline-staged toy event: same candidate node-sets."""
    ev = toymc.generate_event(seed=5, num_tracks=16)
    g, _ = build_graph_state(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs, CFG)
    g = pipeline._prepare_jit(g, CFG)
    g = pipeline._stage_jit(g, CFG, 1, None)
    base = None
    for seed in (0, 1, 2):
        cands = community.detect_communities(g, CFG, seed=seed)
        got = sorted(tuple(sorted(c)) for c in cands)
        assert got, "vacuous: no communities survive the filters"
        if base is None:
            base = got
        else:
            assert got == base, (seed, got, base)
