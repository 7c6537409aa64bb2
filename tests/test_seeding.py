import numpy as np

from gnn_track_finding.config import PipelineConfig
from gnn_track_finding.graph.build import build_graph_state
from gnn_track_finding.models import toymc
from gnn_track_finding.ops import priors

from tests import helpers
from tests.oracle import ref_impl

CFG = PipelineConfig(node_bucket=64, edge_bucket=256)


def insertion_order(G, node):
    return list(G.predecessors(node))


def seeded_pair(seed=0, **kw):
    ev = toymc.generate_event(seed=seed, **kw)
    g, _ = build_graph_state(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs, CFG)
    g = helpers.seed_j(g, CFG)
    G = toymc.to_networkx(ev)
    ref_impl.seed_states(G, CFG, neighbour_order=insertion_order)
    return ev, g, G


def test_seed_states_match_oracle():
    ev, g, G = seeded_pair()
    src = np.asarray(g.src)
    dst = np.asarray(g.dst)
    sv = np.asarray(g.seed_sv)
    cov = np.asarray(g.seed_cov)
    joint = np.asarray(g.seed_joint)
    jcov = np.asarray(g.seed_joint_cov)
    for e in range(g.n_edges):
        ref = G.nodes[dst[e]]["track_state_estimates"][src[e]]
        np.testing.assert_allclose(sv[e], ref["edge_state_vector"],
                                   rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(cov[e], ref["edge_covariance"],
                                   rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(joint[e], ref["joint_vector"],
                                   rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(jcov[e], ref["joint_vector_covariance"],
                                   rtol=1e-9, atol=1e-12)


def test_gradient_stats_match_oracle():
    ev, g, G = seeded_pair(seed=3)
    gs = np.asarray(g.grad_stats)
    for node in range(g.n_nodes):
        mx, vx = G.nodes[node]["xy_edge_gradient_mean_var"]
        mz, vz = G.nodes[node]["zr_edge_gradient_mean_var"]
        np.testing.assert_allclose(gs[node], [mx, vx, mz, vz],
                                   rtol=1e-9, atol=1e-10)


def test_weights_priors_degrees_match_oracle():
    ev, g, G = seeded_pair(seed=5)
    g = priors.initialize_edge_activation(g)
    g = helpers.weights_j(g, False)
    g = helpers.priors_j(g, False)
    g = helpers.degrees_j(g)

    ref_impl.initialize_edge_activation(G)
    ref_impl.compute_mixture_weights(G, "track_state_estimates")
    ref_impl.compute_prior_probabilities(G, "track_state_estimates")
    ref_impl.update_degrees(G)

    src = np.asarray(g.src)
    dst = np.asarray(g.dst)
    w = np.asarray(g.seed_weight)
    p = np.asarray(g.seed_prior)
    deg = np.asarray(g.degree)
    for e in range(g.n_edges):
        ref = G.nodes[dst[e]]["track_state_estimates"][src[e]]
        np.testing.assert_allclose(w[e], ref["mixture_weight"], rtol=1e-12)
        np.testing.assert_allclose(p[e], ref["prior"], rtol=1e-12)
    for node in range(g.n_nodes):
        assert deg[node] == G.nodes[node]["degree"]
