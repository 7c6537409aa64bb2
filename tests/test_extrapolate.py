import numpy as np

from gnn_track_finding.config import PipelineConfig
from gnn_track_finding.graph.build import build_graph_state
from gnn_track_finding.models import toymc

from tests import helpers
from tests.oracle import ref_impl

CFG = PipelineConfig(node_bucket=64, edge_bucket=256)


def insertion_order(G, node):
    return list(G.predecessors(node))


def successors_order(G, node):
    return list(G.successors(node))


def prepared_clustered(seed=11, **kw):
    ev = toymc.generate_event(seed=seed, **kw)
    g, _ = build_graph_state(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs, CFG)
    g = helpers.seed_and_init(g, CFG)
    g = helpers.cluster_j(g, CFG, False)

    G = toymc.to_networkx(ev)
    ref_impl.seed_states(G, CFG, neighbour_order=insertion_order)
    ref_impl.initialize_edge_activation(G)
    ref_impl.compute_mixture_weights(G, "track_state_estimates")
    ref_impl.compute_prior_probabilities(G, "track_state_estimates")
    ref_impl.cluster(G, "track_state_estimates",
                     CFG.chi2_threshold_seed, CFG.kl_threshold_seed, CFG)
    return ev, g, G


def test_extrapolation_stage_matches_oracle():
    ev, g, G = prepared_clustered(num_tracks=16, edge_dphi_window=0.12)

    g2 = helpers.extrapolation_stage(g, CFG)

    ref_impl.extrapolation_stage(G, CFG, neighbour_order=successors_order)

    src = np.asarray(g2.src)
    dst = np.asarray(g2.dst)
    has_u = np.asarray(g2.has_updated)
    act = np.asarray(g2.active)
    usv = np.asarray(g2.upd_sv)
    ucov = np.asarray(g2.upd_cov)
    ujoint = np.asarray(g2.upd_joint)
    ujcov = np.asarray(g2.upd_joint_cov)
    uw = np.asarray(g2.upd_weight)
    ul = np.asarray(g2.upd_likelihood)
    upr = np.asarray(g2.upd_prior)

    n_updated = 0
    for e in range(g2.n_edges):
        s, d = src[e], dst[e]
        ref_states = G.nodes[d].get("updated_track_states", {})
        ref_has = s in ref_states
        assert bool(has_u[e]) == ref_has, f"edge {s}->{d}"
        assert bool(act[e]) == (G[s][d]["activated"] == 1), f"edge {s}->{d}"
        if ref_has:
            n_updated += 1
            r = ref_states[s]
            np.testing.assert_allclose(usv[e], r["edge_state_vector"],
                                       rtol=1e-6, atol=1e-12, err_msg=f"{s}->{d}")
            np.testing.assert_allclose(ucov[e], r["edge_covariance"],
                                       rtol=1e-7, atol=1e-14)
            np.testing.assert_allclose(ujoint[e], r["joint_vector"],
                                       rtol=1e-6, atol=1e-12)
            np.testing.assert_allclose(ujcov[e], r["joint_vector_covariance"],
                                       rtol=1e-7, atol=1e-14)
            np.testing.assert_allclose(ul[e], r["likelihood"], rtol=1e-8)
            np.testing.assert_allclose(uw[e], r["mixture_weight"],
                                       rtol=1e-8, err_msg=f"weight {s}->{d}")
            if "prior" in r:
                np.testing.assert_allclose(upr[e], r["prior"], rtol=1e-10)
    assert n_updated > 0, "no updated states produced — test is vacuous"

    deg = np.asarray(g2.degree)
    for node in range(g2.n_nodes):
        assert deg[node] == G.nodes[node]["degree"], f"degree node {node}"

    # merged_cov mutation parity (cumulative var_ms, ref :127-128)
    mc = np.asarray(g2.merged_cov)
    for node in range(g2.n_nodes):
        if "merged_cov" in G.nodes[node]:
            np.testing.assert_allclose(mc[node], G.nodes[node]["merged_cov"],
                                       rtol=1e-6, atol=1e-12)


def test_prior_reweight_fused_matches_separate():
    """The fused prior+reweight pass (one shared table scatter + one
    packed node-table gather) is numerically identical to
    compute_prior_probabilities -> reweight."""
    import jax
    from gnn_track_finding.models import pipeline as pl
    from gnn_track_finding.ops import priors

    ev = toymc.generate_event(seed=9, num_tracks=18, edge_dphi_window=0.12)
    g, _ = build_graph_state(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs, CFG)
    g = pl._prepare_jit(g, CFG)
    g = pl._stage_jit(g, CFG, 1, None)
    from gnn_track_finding.ops import extrapolate
    g = jax.jit(extrapolate.message_passing, static_argnums=1)(g, CFG)

    a = priors.reweight(
        priors.compute_prior_probabilities(g, use_updated=True), CFG)
    b = priors.prior_reweight(g, CFG)
    np.testing.assert_array_equal(np.asarray(a.active), np.asarray(b.active))
    np.testing.assert_array_equal(np.asarray(a.upd_prior),
                                  np.asarray(b.upd_prior))
    np.testing.assert_array_equal(np.asarray(a.upd_weight),
                                  np.asarray(b.upd_weight))
    # and a second fused round on the first round's output
    a2 = priors.reweight(
        priors.compute_prior_probabilities(a, use_updated=True), CFG)
    b2 = priors.prior_reweight(b, CFG)
    np.testing.assert_array_equal(np.asarray(a2.active), np.asarray(b2.active))
    np.testing.assert_array_equal(np.asarray(a2.upd_weight),
                                  np.asarray(b2.upd_weight))


def test_reweight_stage_matches_double_prior_reweight():
    """The table-resident reweight_stage (one scatter/gather cycle for
    BOTH passes + degrees) equals two prior_reweight passes followed by
    update_degrees.  Priors and actives are exact (integer counts /
    identical products); weights may differ in the last ulp because the
    mixture denominator is a row-sum over in-table slots instead of a
    segment_sum over edges."""
    import jax
    from gnn_track_finding.models import pipeline as pl
    from gnn_track_finding.ops import extrapolate, priors

    ev = toymc.generate_event(seed=11, num_tracks=24, edge_dphi_window=0.15)
    g, _ = build_graph_state(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs, CFG)
    g = pl._prepare_jit(g, CFG)
    g = pl._stage_jit(g, CFG, 1, None)
    g = jax.jit(extrapolate.message_passing, static_argnums=1)(g, CFG)

    a = priors.update_degrees(
        priors.prior_reweight(priors.prior_reweight(g, CFG), CFG))
    b = priors.reweight_stage(g, CFG, n_passes=2)
    assert bool((g.has_updated & g.active & g.edge_mask).sum()) > 0
    np.testing.assert_array_equal(np.asarray(a.active), np.asarray(b.active))
    np.testing.assert_array_equal(np.asarray(a.degree), np.asarray(b.degree))
    np.testing.assert_array_equal(np.asarray(a.upd_prior),
                                  np.asarray(b.upd_prior))
    np.testing.assert_allclose(np.asarray(a.upd_weight),
                               np.asarray(b.upd_weight), rtol=1e-12)


def test_distinct_counts_match_set_oracle():
    """priors._distinct_counts: per (node, side), the number of DISTINCT
    x values among the ok slots (helper.py:127-134 len(set())), on
    duplicate-heavy tables, against a plain NumPy set count."""
    import jax.numpy as jnp

    from gnn_track_finding.ops import priors

    rng = np.random.default_rng(0)
    n, k = 64, 16
    x_vals = rng.choice([1.5, 2.5, 3.5, -1.0, 0.0], size=(n, k))
    ok = rng.uniform(size=(n, k)) < 0.6
    x_slot = np.where(ok, x_vals, 0.0)
    node_x = rng.normal(size=(n,)) * 2.0
    left = x_slot < node_x[:, None]
    got = np.asarray(priors._distinct_counts(
        jnp.asarray(ok), jnp.asarray(x_slot), jnp.asarray(left),
        jnp.float64))
    want = np.array([[len({x_slot[i, j] for j in range(k)
                           if ok[i, j] and left[i, j] == side})
                      for side in (True, False)] for i in range(n)])
    np.testing.assert_array_equal(got, want)
    assert (want > 1).any() and (want < ok.sum(axis=1)[:, None]).any()
