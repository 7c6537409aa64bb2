"""Mixture weights, layer priors, degrees and Gaussian-mixture reweighting.

Vectorised re-designs of the reference's graph-walking helpers:

  * compute_mixture_weights  (helper.py:76-96)   -> segment count + gather
  * compute_prior_probabilities (helper.py:30-63) -> segment count over a
    (node, src-layer) composite key
  * query_node_degree_in_edges (helper.py:67-73) -> segment sum of active
  * reweight + calculate_side_norm_factor (helper.py:99-225) -> edge-wise
    renormalisation with a per-node distinct-coordinate count done on the
    fixed-K in-edge table.

Dict-membership semantics: an edge e carries a SEED state whenever it
exists (edge_mask), and an UPDATED state when has_updated[e] — matching the
reference's 'track_state_estimates' / 'updated_track_states' dicts.  Stale
entries of deactivated edges keep their previous prior/weight values, as in
the reference (only active edges are reassigned).

Deviation from the reference (documented): helper.py:129-139 decides each
side's lr_layer_norm with a stale loop variable ``neighbour_num`` (the last
neighbour iterated), and helper.py:199-200 uses ``=`` where ``+=`` was
meant in the confusion-matrix counters.  We implement the intended
semantics: an active edge gets its side's distinct-coordinate norm; the
counters accumulate.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from gnn_track_finding.config import PipelineConfig
from gnn_track_finding.graph.state import GraphState
from gnn_track_finding.ops import collect, gtools


def _state_membership(g: GraphState, use_updated: bool) -> jax.Array:
    return g.has_updated if use_updated else g.edge_mask


def compute_mixture_weights(g: GraphState, use_updated: bool,
                            axis_name=None) -> GraphState:
    """weight = 1 / len(state dict at the head node) (helper.py:88-94)."""
    member = _state_membership(g, use_updated)
    n = g.num_padded_nodes
    count = collect.allsum(
        jax.ops.segment_sum(member.astype(g.dtype), g.dst, n), axis_name)
    w = 1.0 / jnp.maximum(count, 1.0)
    new_w = jnp.where(member, gtools.gather1d(w, g.dst), 0.0)
    if use_updated:
        return g.replace(upd_weight=new_w)
    return g.replace(seed_weight=new_w)


def compute_prior_probabilities(g: GraphState, use_updated: bool,
                                axis_name=None) -> GraphState:
    """prior = 1 / (#active same-src-layer edges into the head node)
    (helper.py:43-63); inactive entries keep their previous prior."""
    member = _state_membership(g, use_updated)
    eligible = member & g.active & g.edge_mask
    key = g.dst * g.n_layers + g.e_src_layer
    num_seg = g.num_padded_nodes * g.n_layers
    count = collect.allsum(
        jax.ops.segment_sum(eligible.astype(g.dtype), key, num_seg),
        axis_name)
    count_e = gtools.table_lookup(count.reshape(-1, g.n_layers),
                                  g.dst, g.e_src_layer)
    prior = 1.0 / jnp.maximum(count_e, 1.0)
    old = g.upd_prior if use_updated else g.seed_prior
    new = jnp.where(eligible, prior, old)
    if use_updated:
        return g.replace(upd_prior=new)
    return g.replace(seed_prior=new)


def update_degrees(g: GraphState, axis_name=None) -> GraphState:
    """Active in-degree per node (helper.py:67-73)."""
    act = (g.edge_mask & g.active).astype(jnp.int32)
    deg = collect.allsum(
        jax.ops.segment_sum(act, g.dst, g.num_padded_nodes), axis_name)
    return g.replace(degree=deg)


def _side_norms(g: GraphState, axis_name=None) -> jax.Array:
    """Per-edge distinct-x count of same-side active updated in-edges.

    Reference: calculate_side_norm_factor (helper.py:99-139).  The side of
    edge e=(src->dst) is 'left' when x_src < x_dst; the norm is the number
    of DISTINCT x coordinates among the head's active updated in-senders on
    that side.  Computed as a masked first-occurrence count over the
    fixed-K in-edge table (scatter + fused (N, K, K) compare-reduce).
    """
    ok = g.has_updated & g.active & g.edge_mask
    # neighbour x comes from the updated dict's coordinate snapshot
    # (helper.py:113 reads updated_track_states[...]['xyzr'][0]); node x
    # is the LIVE GNN_Measurement coordinate (helper.py:104), which
    # extraction's close-proximity merge may have mutated.
    xs = g.upd_xyzr[:, 0]
    node_x = g.gnn_xyzr[:, 0]
    left = xs < gtools.gather1d(node_x, g.dst)

    # slot-space distinct-count: ok flags and snapshot x scatter into the
    # in-table (scatters are tile-efficient; under the edge partition each
    # (node, slot) cell has exactly one writer, so the cross-shard combine
    # is an exact psum).
    ok_slot = collect.allor(
        jnp.zeros(g.in_edges.shape, bool).at[g.dst, g.slot_in].max(ok),
        axis_name)
    # route non-ok edges out of bounds so their writes are DROPPED: padded
    # edges all carry (dst=0, slot_in=0) and a plain duplicate-index .set
    # would race their 0.0 against the real edge occupying that slot
    row = jnp.where(ok, g.dst, g.in_edges.shape[0])
    x_slot = collect.allsum(
        jnp.zeros(g.in_edges.shape, g.dtype).at[row, g.slot_in].set(
            xs, mode="drop"),
        axis_name)
    left_slot = x_slot < node_x[:, None]
    counts = _distinct_counts(ok_slot, x_slot, left_slot, g.dtype)  # (N, 2)
    side = jnp.where(left, 0, 1)
    norms = jnp.where(ok, gtools.table_lookup(counts, g.dst, side), 1.0)
    return jnp.maximum(norms, 1.0)


def _distinct_counts(ok_slot: jax.Array, x_slot: jax.Array,
                     left_slot: jax.Array, dtype) -> jax.Array:
    """(N, 2) distinct-x count per (node, side) — masked first-occurrence
    count over (K, K) slot pairs, exact equality on raw values
    (helper.py:127-134 len(set(x)) semantics)."""
    k_tab = x_slot.shape[1]
    eqx = x_slot[:, :, None] == x_slot[:, None, :]
    same_side = left_slot[:, :, None] == left_slot[:, None, :]
    earlier = jnp.tril(jnp.ones((k_tab, k_tab), bool), k=-1)   # j < i
    dup_before = jnp.any(
        eqx & same_side & ok_slot[:, None, :] & earlier[None], axis=2)
    first = ok_slot & ~dup_before
    return jnp.stack([
        jnp.sum(first & left_slot, axis=1),
        jnp.sum(first & ~left_slot, axis=1)], axis=1).astype(dtype)


def prior_reweight(g: GraphState, cfg: PipelineConfig,
                   axis_name=None, routing=None) -> GraphState:
    """Fused prior recompute + Gaussian-mixture reweight — one pass of the
    reference's back-to-back calls (extrapolate_merged_states.py:554-559).

    The prior's eligibility set (helper.py:49-52) and the reweight's
    membership (helper.py:158-161) are the SAME predicate
    (updated & active & existing), so the pair shares ONE in-table scatter
    pass and ONE packed node-table row gather:

      * prior per-(node, src-layer) counts reduce over the scattered
        ok table against the static in_src_layer cache — no second
        (N*L)-segment scatter and (E, L) row gather;
      * denom, node x, and the side-norm distinct counts ride the same
        packed (N, L+4) table, gathered once per edge.

    Numerics are identical to compute_prior_probabilities -> reweight
    (integer counts; same denom segment_sum; same distinct-count block) —
    asserted in tests/test_extrapolate.py.

    Under an edge partition (axis_name set) the combine uses the
    NODE-OWNER exchange: the (N, K) scatter partials reduce_scatter to
    contiguous node-row owners, the per-node reductions run on the owner
    (so the (N, K, K) distinct-count block parallelises too), and only
    the (N, L+4) packed result is all_gathered — replacing the two full
    (N, K) f32 table all-reduces of the naive pattern
    (docs/DESIGN.md 'Multi-chip model').
    """
    member = g.has_updated & g.active & g.edge_mask
    n = g.num_padded_nodes
    n_l = g.n_layers
    k_tab = g.in_edges.shape[1]
    dtype = g.dtype

    xs = g.upd_xyzr[:, 0]
    wl = jnp.where(member, g.upd_weight * g.upd_likelihood, 0.0)
    node_x = g.gnn_xyzr[:, 0]

    def node_results(ok_slot, x_slot, denom, node_x_r, layer_tab):
        """Per-node outputs from the combined tables: (rows, L+4) packed
        [prior counts per layer | mixture denom | node x | side-norm
        distinct counts]."""
        count_nl = jnp.stack(
            [jnp.sum(ok_slot & (layer_tab == l), axis=1)
             for l in range(n_l)], axis=1).astype(dtype)       # (rows, L)
        left_slot = x_slot < node_x_r[:, None]
        counts2 = _distinct_counts(ok_slot, x_slot, left_slot, dtype)
        return jnp.concatenate([count_nl, denom[:, None],
                                node_x_r[:, None], counts2], axis=1)

    row_idx = g.dst   # row of the packed result table per edge
    if routing is not None and collect.owner_shards(n, axis_name):
        # Node-owner all_to_all exchange (parallel/edge_shard.OwnerRouting):
        # each edge SENDS its scatter payload (x snapshot, w*L term, member
        # flag) straight to its head's owner shard; the owner rebuilds its
        # block of the tables, computes the per-node results there (the
        # (rows, K, K) distinct-count block parallelises too), and only
        # the (N, L+4) result is all_gathered.  The wire carries E*3 f32
        # payloads + the narrow result — not the two (N, K) f32 table
        # all-reduces of the naive combine.
        d = routing.n_shards
        rows = n // d
        vals = jnp.stack([jnp.where(member, xs, 0.0), wl,
                          member.astype(dtype)], axis=1)       # (E_loc, 3)
        recv = collect.route_to_owners(vals, routing.owner, routing.pos,
                                       routing.bucket, axis_name)
        my = jax.lax.axis_index(axis_name)
        rr = jax.lax.dynamic_index_in_dim(routing.recv_row, my, 0,
                                          keepdims=False)      # (D, B)
        ss = jax.lax.dynamic_index_in_dim(routing.recv_slot, my, 0,
                                          keepdims=False)
        valid = rr >= 0
        ok_recv = valid & (recv[..., 2] > 0.5)
        row_ok = jnp.where(ok_recv, rr, rows)
        ok_own = jnp.zeros((rows, k_tab), bool).at[row_ok, ss].max(
            ok_recv, mode="drop")
        x_own = jnp.zeros((rows, k_tab), dtype).at[row_ok, ss].set(
            jnp.where(ok_recv, recv[..., 0], 0.0), mode="drop")
        denom_own = jnp.zeros((rows,), dtype).at[
            jnp.where(valid, rr, rows)].add(
            jnp.where(valid, recv[..., 1], 0.0), mode="drop")
        table = collect.gather_rows(
            node_results(ok_own, x_own, denom_own,
                         collect.owner_block_interleaved(node_x, axis_name),
                         collect.owner_block_interleaved(g.in_src_layer,
                                                         axis_name)),
            axis_name)                                         # (N, L+4)
        row_idx = routing.own_idx     # owner-major row of dst, static
    else:
        # local scatter partials + dense combine (reduce_scatter to
        # contiguous owners when the tiling divides, else plain psum)
        ok_part = jnp.zeros(g.in_edges.shape, bool).at[
            g.dst, g.slot_in].max(member)
        row = jnp.where(member, g.dst, g.in_edges.shape[0])
        x_part = jnp.zeros(g.in_edges.shape, g.dtype).at[row, g.slot_in].set(
            xs, mode="drop")
        denom_part = jax.ops.segment_sum(wl, g.dst, n)
        if collect.owner_shards(n, axis_name):
            table = collect.gather_rows(
                node_results(collect.ownor(ok_part, axis_name),
                             collect.ownsum(x_part, axis_name),
                             collect.ownsum(denom_part, axis_name),
                             collect.owner_block(node_x, axis_name),
                             collect.owner_block(g.in_src_layer, axis_name)),
                axis_name)                                     # (N, L+4)
        else:
            table = node_results(collect.allor(ok_part, axis_name),
                                 collect.allsum(x_part, axis_name),
                                 collect.allsum(denom_part, axis_name),
                                 node_x, g.in_src_layer)

    # --- ONE packed node-table row gather for everything per-edge ---
    # per-edge selects ride one-hot multiply-reduce / where-selects
    pe = table[row_idx]                                        # (E, L+4)
    count_e = gtools.onehot_select(pe[:, :n_l], g.e_src_layer)
    denom_e = pe[:, n_l]
    node_x_e = pe[:, n_l + 1]

    prior = 1.0 / jnp.maximum(count_e, 1.0)
    new_prior = jnp.where(member, prior, g.upd_prior)

    left = xs < node_x_e
    norms = jnp.where(
        member,
        jnp.where(left, pe[:, n_l + 2], pe[:, n_l + 3]),
        1.0)
    norms = jnp.maximum(norms, 1.0)

    from gnn_track_finding.ops import linalg
    w_new = wl * new_prior / jnp.maximum(denom_e, linalg.tiny(dtype)) / norms
    new_weight = jnp.where(member, w_new, g.upd_weight)
    drop = member & (w_new < cfg.reweight_threshold)
    return g.replace(upd_prior=new_prior, upd_weight=new_weight,
                     active=g.active & ~drop)


def reweight_stage(g: GraphState, cfg: PipelineConfig,
                   n_passes: int = 2) -> GraphState:
    """TABLE-RESIDENT double prior/reweight + degree recount — the whole
    post-message-passing tail of an extrapolation iteration
    (extrapolate_merged_states.py:554-566: compute_prior_probabilities +
    reweight, twice, then the degree refresh) in ONE scatter/gather cycle.

    prior_reweight pays, per pass, three edge->table scatters and one
    packed (E, L+4) row gather.  But every per-node reduction it needs
    (layer counts, mixture denominator, distinct-x side norms, degrees)
    is a ROW reduction over the (N, K) in-edge table, and the per-edge
    values it consumes (x snapshot, weight*likelihood) live at unique
    (dst, slot_in) cells of that same table.  So: scatter the edge
    payloads into tables ONCE, run all passes as row-local table math
    (weights evolve in table space — pass 2's scatters disappear
    entirely), and gather the per-edge results (prior, weight, drop)
    back ONCE at the end.  Numerics per pass are the same integer counts
    and the same products as prior_reweight; only the mixture-denominator
    summation order changes (row-sum over slots vs segment_sum over
    edges — last-ulp, covered by the oracle tolerances).

    The degree refresh (helper.py:67-73) rides the same tables: active
    flags scatter once, pass drops clear table cells, and the final
    degree is a row-sum — no separate segment_sum pass.
    """
    n = g.num_padded_nodes
    n_l = g.n_layers
    k_tab = g.in_edges.shape[1]
    dtype = g.dtype

    member = g.has_updated & g.active & g.edge_mask
    xs = g.upd_xyzr[:, 0]
    node_x = g.gnn_xyzr[:, 0]
    layer_tab = g.in_src_layer

    # ---- scatter-in, once: padded edges route out of bounds (drop) so
    # their (dst=0, slot=0) fill never races the real occupant.  The x
    # table doubles as the membership flag (+inf sentinel on unwritten
    # cells — a coordinate is never inf), saving a bool scatter ----
    row = jnp.where(member, g.dst, n)
    x_tab = jnp.full((n, k_tab), jnp.inf, dtype).at[row, g.slot_in].set(
        xs, mode="drop")
    ok_tab = x_tab < jnp.inf
    wl_tab = jnp.zeros((n, k_tab), dtype).at[row, g.slot_in].set(
        g.upd_weight * g.upd_likelihood, mode="drop")
    lik_tab = jnp.zeros((n, k_tab), dtype).at[row, g.slot_in].set(
        g.upd_likelihood, mode="drop")
    act_tab = jnp.zeros((n, k_tab), bool).at[g.dst, g.slot_in].max(
        g.edge_mask & g.active)

    left_tab = x_tab < node_x[:, None]   # inf sentinel -> False, masked
    prior_out = jnp.zeros((n, k_tab), dtype)
    w_out = jnp.zeros((n, k_tab), dtype)

    for _ in range(n_passes):
        start = ok_tab
        count_nl = jnp.stack(
            [jnp.sum(start & (layer_tab == l), axis=1)
             for l in range(n_l)], axis=1).astype(dtype)        # (N, L)
        count_slot = jnp.zeros((n, k_tab), dtype)
        for l in range(n_l):
            count_slot = count_slot + jnp.where(
                layer_tab == l, count_nl[:, l:l + 1], 0.0)
        prior_tab = 1.0 / jnp.maximum(count_slot, 1.0)
        denom = jnp.sum(wl_tab, axis=1)                         # (N,)
        counts2 = _distinct_counts(start, x_tab, left_tab, dtype)
        norm_tab = jnp.maximum(
            jnp.where(left_tab, counts2[:, 0:1], counts2[:, 1:2]), 1.0)
        from gnn_track_finding.ops import linalg
        w_new = (wl_tab * prior_tab
                 / jnp.maximum(denom, linalg.tiny(dtype))[:, None]
                 / norm_tab)
        prior_out = jnp.where(start, prior_tab, prior_out)
        w_out = jnp.where(start, w_new, w_out)
        drop_tab = start & (w_new < cfg.reweight_threshold)
        ok_tab = start & ~drop_tab
        act_tab = act_tab & ~drop_tab
        wl_tab = jnp.where(ok_tab, w_new * lik_tab, 0.0)

    degree = jnp.sum(act_tab, axis=1).astype(jnp.int32)

    # ---- gather-out, once: TWO f32 one-hot multiply-reduce lookups
    # (ops/gtools — the measured tile-safe two-index form).  No flag
    # lookups needed: the ever-assigned set IS `member` (pass-2 members
    # are a subset of pass-1's), and an edge was dropped — in WHICHEVER
    # pass — iff its final weight sits below the threshold (a pass-1
    # drop keeps its sub-threshold w1 because pass 2 never reassigns
    # non-members; a surviving edge's final w2 passed the gate) ----
    prior_e = gtools.table_lookup(prior_out, g.dst, g.slot_in)
    w_e = gtools.table_lookup(w_out, g.dst, g.slot_in)
    dropped_e = member & (w_e < cfg.reweight_threshold)
    return g.replace(
        upd_prior=jnp.where(member, prior_e, g.upd_prior),
        upd_weight=jnp.where(member, w_e, g.upd_weight),
        active=g.active & ~dropped_e,
        degree=degree,
    )


def reweight(g: GraphState, cfg: PipelineConfig,
             axis_name=None) -> GraphState:
    """Gaussian-mixture reweighting with threshold deactivation
    (helper.py:143-201): w' = w * L * prior / sum(w * L) / side_norm, then
    deactivate edges with w' < reweight_threshold."""
    member = g.has_updated & g.active & g.edge_mask
    n = g.num_padded_nodes
    wl = jnp.where(member, g.upd_weight * g.upd_likelihood, 0.0)
    denom = collect.allsum(jax.ops.segment_sum(wl, g.dst, n), axis_name)
    norms = _side_norms(g, axis_name)
    denom_e = gtools.gather1d(denom, g.dst)
    from gnn_track_finding.ops import linalg
    w_new = wl * g.upd_prior / jnp.maximum(denom_e, linalg.tiny(g.dtype)) / norms
    new_weight = jnp.where(member, w_new, g.upd_weight)
    drop = member & (w_new < cfg.reweight_threshold)
    return g.replace(upd_weight=new_weight, active=g.active & ~drop)


def initialize_edge_activation(g: GraphState) -> GraphState:
    """All existing edges start activated (helper.py:24-25)."""
    return g.replace(active=g.edge_mask)
