import numpy as np
import networkx as nx

from gnn_track_finding.config import PipelineConfig
from gnn_track_finding.graph.build import build_graph_state
from gnn_track_finding.models import toymc

CFG = PipelineConfig(node_bucket=64, edge_bucket=256)


def build_toy(seed=0, **kw):
    ev = toymc.generate_event(seed=seed, **kw)
    g, host = build_graph_state(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs, CFG)
    return ev, g, host


def test_shapes_and_masks():
    ev, g, _ = build_toy()
    n = ev.xyzr.shape[0]
    assert g.n_nodes == n
    assert g.n_edges == 2 * ev.edge_pairs.shape[0]
    assert int(g.node_mask.sum()) == n
    assert int(g.edge_mask.sum()) == g.n_edges
    assert g.num_padded_nodes % CFG.node_bucket == 0
    assert g.num_padded_edges % CFG.edge_bucket == 0
    # bidirectional interleaving contract: the reverse of edge e is e ^ 1
    # (ops rely on it for the pair-swap weight lookup, no reverse index
    # array needed)
    e = g.n_edges
    rev = np.arange(e) ^ 1
    src = np.asarray(g.src)[:e]
    dst = np.asarray(g.dst)[:e]
    assert np.array_equal(src[rev], dst)
    assert np.array_equal(dst[rev], src)


def test_edge_tables_match_networkx_order():
    # the fixed-K tables keep RAW CSV insertion order (the reference's
    # dict-storage layout before the event-conversion rebuild)
    ev, g, _ = build_toy()
    G = toymc.to_networkx(ev, reference_orders=False)
    in_tab = np.asarray(g.in_edges)
    out_tab = np.asarray(g.out_edges)
    src = np.asarray(g.src)
    dst = np.asarray(g.dst)
    for node in list(G.nodes())[:50]:
        preds = list(G.predecessors(node))
        row = in_tab[node]
        row = row[row >= 0]
        assert [src[e] for e in row] == preds
        assert all(dst[e] == node for e in row)
        succs = list(G.successors(node))
        orow = out_tab[node]
        orow = orow[orow >= 0]
        assert [dst[e] for e in orow] == succs


def test_components_match_networkx():
    ev, g, _ = build_toy()
    G = toymc.to_networkx(ev)
    comp = np.asarray(g.component)[:g.n_nodes]
    nx_comps = list(nx.weakly_connected_components(G))
    # same partition
    label_of = {}
    for nodes in nx_comps:
        lab = min(nodes)
        for nd in nodes:
            label_of[nd] = lab
    for nd, lab in label_of.items():
        assert comp[nd] == lab


def test_duplicate_edges_deduped():
    ev = toymc.generate_event(seed=1)
    dup = np.concatenate([ev.edge_pairs, ev.edge_pairs[:5],
                          ev.edge_pairs[:3][:, ::-1]])
    g, _ = build_graph_state(ev.xyzr, ev.vivl, ev.truth, dup, CFG)
    assert g.n_edges == 2 * ev.edge_pairs.shape[0]


def test_nxorder_tracker_matches_real_networkx():
    """The nxorder replica must reproduce what actual NetworkX + CPython
    produce through the reference's rebuild chain (nx.DiGraph -> WCC ->
    subgraph(c).copy(), event_conversion.py:80-84)."""
    for seed in (0, 3, 9):
        ev, g, host = build_toy(seed=seed)
        G = toymc.to_networkx(ev)          # real rebuilt adjacency orders
        orders = host.tracker.neighbour_orders()
        for node in G.nodes():
            ref = list(set(nx.all_neighbors(G, node)))   # helper.py:280
            assert orders[node] == ref, f"seed {seed} node {node}"


def test_nxorder_extraction_candidate_orders():
    """Candidate node orders through extraction's CCA + subgraph.copy
    (extract_track_candidates.py:332-346) vs real NetworkX, with some
    edges deactivated."""
    import random
    for seed in (1, 5):
        ev, g, host = build_toy(seed=seed)
        e = g.n_edges
        rng = random.Random(seed)
        active = np.ones(g.num_padded_edges, bool)
        src = np.asarray(g.src)
        dst = np.asarray(g.dst)
        for i in range(e):
            if rng.random() < 0.2:
                active[i] = False

        # ground truth with real networkx
        G = toymc.to_networkx(ev)
        expected = []
        edge_idx = {(int(src[i]), int(dst[i])): i for i in range(e)}
        parts = [G.subgraph(c).copy()
                 for c in nx.weakly_connected_components(G)]
        for part in parts:
            sub = part.copy()
            removed = [(u, v) for u, v in sub.edges()
                       if not active[edge_idx[(u, v)]]]
            cands = []
            if removed:
                for u, v in removed:
                    sub.remove_edge(u, v)
                for c in nx.weakly_connected_components(sub):
                    cands.append(list(sub.subgraph(c).copy().nodes()))
            else:
                cands.append(list(sub.nodes()))
            expected.append(cands)

        # tracker replica: reuse extraction_merges internals by probing
        # the candidate orders via the mutation path is indirect; instead
        # validate the building blocks it uses
        from gnn_track_finding.graph import nxorder
        tr = host.tracker
        got = []
        for subg in tr.subgraphs:
            pos = {u: i for i, u in enumerate(subg.node_order)}
            csucc = {u: [w for w in subg.succ[u]
                         if active[edge_idx[(u, w)]]] for u in subg.node_order}
            cpred = {u: [w for w in sorted(subg.pred[u], key=pos.__getitem__)
                         if active[edge_idx[(w, u)]]] for u in subg.node_order}
            removed_any = any(len(csucc[u]) != len(subg.succ[u])
                              for u in subg.node_order)
            cands = []
            if removed_any:
                seen = set()
                n = len(subg.node_order)
                for v in subg.node_order:
                    if v in seen:
                        continue
                    c, _ = nxorder._plain_bfs_set(v, csucc, cpred, int)
                    seen.update(c)
                    cands.append(nxorder._subgraph_copy_node_order(
                        c, subg.node_order, n, int,
                        {x: x for x in c}))
            else:
                cands.append(list(subg.node_order))
            got.append(cands)
        assert got == expected, f"seed {seed}"


def test_cca_fastsv_matches_paired():
    """FastSV hooking CCA (graph/cca.py) == label propagation == NetworkX
    under random edge deactivation."""
    import random
    import jax.numpy as jnp
    from gnn_track_finding.graph import cca

    for seed in (0, 2, 4):
        ev, g, _ = build_toy(seed=seed, num_tracks=14)
        rng = random.Random(seed)
        ok = np.asarray(g.edge_mask).copy()
        for i in range(g.n_edges):
            if rng.random() < 0.3:
                ok[i] = False
        okj = jnp.asarray(ok)
        l_prop = np.asarray(cca.connected_components_paired(g, okj))
        l_sv = np.asarray(cca.connected_components_fastsv(g, okj))
        assert np.array_equal(l_prop, l_sv)

        # ground truth: undirected connectivity over surviving edges
        G = nx.Graph()
        G.add_nodes_from(range(g.n_nodes))
        src = np.asarray(g.src)
        dst = np.asarray(g.dst)
        for e in range(g.n_edges):
            if ok[e]:
                G.add_edge(int(src[e]), int(dst[e]))
        for comp in nx.connected_components(G):
            lab = min(comp)
            for nd in comp:
                assert l_sv[nd] == lab


def test_cca_gated_extraction_exact():
    """connected_components_gated == full FastSV on everything the size
    gate can see: components <= max_size are exactly labeled with
    label_ok True; oversized components are excluded either by size or by
    label_ok.  Adversarial permuted paths need >warm_rounds hooking
    rounds, exercising the while-loop tail."""
    import jax
    from gnn_track_finding.graph import cca

    rng = np.random.default_rng(7)
    H = 16

    def make_path_graph(sizes, perm_seed):
        prng = np.random.default_rng(perm_seed)
        n = sum(sizes)
        ids = prng.permutation(n)
        pairs = []
        off = 0
        for s in sizes:
            seg = ids[off:off + s]
            pairs += [(int(seg[i]), int(seg[i + 1])) for i in range(s - 1)]
            off += s
        xyzr = np.zeros((n, 4))
        xyzr[:, 0] = np.arange(n)
        xyzr[:, 3] = 1.0 + np.arange(n)
        vivl = np.stack([np.full(n, 7), np.arange(n) % 7], axis=1)
        truth = np.arange(n)
        cfg = PipelineConfig(node_bucket=max(64, n), edge_bucket=256)
        g, _ = build_graph_state(xyzr, vivl, truth.astype(np.int64),
                                 np.array(pairs), cfg)
        return g

    for trial in range(12):
        sizes = [int(rng.integers(2, 33)) for _ in range(4)] + [40]
        g = make_path_graph(sizes, perm_seed=100 + trial)
        ok = g.edge_mask
        full = np.asarray(cca.connected_components_fastsv(g, ok))
        lab, lab_ok, segsz = jax.jit(
            lambda s, o: cca.connected_components_gated(s, o, max_size=H)
        )(g, ok)
        lab, lab_ok, segsz = (np.asarray(lab), np.asarray(lab_ok),
                              np.asarray(segsz))
        nm = np.asarray(g.node_mask)
        comp_of = {}
        for v in np.flatnonzero(nm):
            comp_of.setdefault(full[v], []).append(v)
        for root, members in comp_of.items():
            if len(members) <= H:
                # exact: converged to the min id, settled, right size
                assert all(lab[v] == root for v in members)
                assert lab_ok[root]
                assert segsz[root] == len(members)
            else:
                # every label fragment is hidden from the size gate
                for v in members:
                    L = lab[v]
                    assert (segsz[L] > H) or (not lab_ok[L])


def test_event_cache_round_trip(tmp_path):
    """Binary event cache (data/event_cache.py): a cache-hit rebuild must
    reproduce the cold build's GraphState bit-exactly, including the
    set()-order mirror table, with the tracker skipped on request."""
    import jax.tree_util as jtu
    from gnn_track_finding.models import toymc
    from gnn_track_finding.data import event_cache

    ev = toymc.generate_event(seed=3, num_tracks=12, edge_dphi_window=0.12)
    cfg = PipelineConfig(node_bucket=64, edge_bucket=256)
    g1, h1 = build_graph_state(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs, cfg)
    extra = {"node_ids": np.arange(ev.xyzr.shape[0], dtype=np.int64),
             "hit_ids": [np.array([i]) for i in range(ev.xyzr.shape[0])],
             "hit_particle_ids": [np.array([int(t)]) for t in ev.truth],
             "module_ids": [np.array([i]) for i in range(ev.xyzr.shape[0])]}
    key = "test"
    event_cache.save(str(tmp_path), key, ev.xyzr, ev.vivl, ev.truth,
                     ev.edge_pairs, extra,
                     np.asarray(g1.mirror)[:g1.n_edges],
                     np.asarray(g1.component)[:ev.xyzr.shape[0]])
    hit = event_cache.load(str(tmp_path), key)
    assert hit is not None
    xyzr, vivl, truth, pairs, extra2, pre = hit
    g2, h2 = build_graph_state(xyzr, vivl, truth, pairs, cfg,
                               host_extra=extra2, precomputed=pre,
                               with_tracker=False)
    assert h2.tracker is None
    for a, b in zip(jtu.tree_leaves(g1), jtu.tree_leaves(g2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert [int(x[0]) for x in extra2["hit_particle_ids"]] == \
        [int(t) for t in ev.truth]


def test_clean_mode_skips_mirror_and_never_caches_identity(tmp_path):
    """Clean mode without a tracker skips the set()-order mirror (every
    consumer is bug_compat-gated, ops/seeding.py) — mirror is identity,
    tracker None — and such a build must NOT write the event cache (a
    later bug-compat load would read a wrong mirror)."""
    import dataclasses
    import os
    from gnn_track_finding.models import toymc

    ev = toymc.generate_event(seed=3, num_tracks=12, edge_dphi_window=0.12)
    clean = dataclasses.replace(PipelineConfig(node_bucket=64,
                                               edge_bucket=256),
                                bug_compat=False)
    g, h = build_graph_state(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs,
                             clean, with_tracker=False)
    assert h.tracker is None
    e = g.n_edges
    np.testing.assert_array_equal(np.asarray(g.mirror)[:e], np.arange(e))
    # parity build still computes the real (non-identity) mirror
    gp, hp = build_graph_state(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs,
                               PipelineConfig(node_bucket=64,
                                              edge_bucket=256),
                               with_tracker=False)
    assert (np.asarray(gp.mirror)[:e] != np.arange(e)).any()
    # pipeline results agree between clean builds with and without the
    # (unused) order emulation
    from gnn_track_finding.models import pipeline
    g2, _ = build_graph_state(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs,
                              clean, with_tracker=True)
    out1 = pipeline.run_pipeline_fast(g, clean)
    out2 = pipeline.run_pipeline_fast(g2, clean)
    key = lambda c: (c.iteration, tuple(sorted(int(x) for x in c.nodes)))
    assert sorted(map(key, out1.candidates)) == \
        sorted(map(key, out2.candidates))
