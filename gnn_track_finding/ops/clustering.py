"""Gaussian-mixture reduction (clustering) as a node-parallel kernel.

Re-design of the reference's per-node Python clustering loop
(clustering.py:149-316): for every node whose state dict holds 3..15
entries (gate at clustering.py:207), compute the pairwise Mahalanobis chi2
matrix over joint [a, b, tau] states (clustering.py:11-86), merge the best
pair when it beats the chi2 threshold (clustering.py:228-234), then greedily
absorb remaining states while the KL distance to the running merged state
beats the KL threshold (clustering.py:261-287), finally deactivating the
in-edges of unabsorbed states (clustering.py:296-316, applied simultaneously).

Device mapping: states are gathered through a compacted (N, 16) in-edge table
(16 = the reference's own upper degree gate), the pairwise matrix is a
masked (N, 16, 16) batch, and the data-dependent while-loop becomes a
fixed-trip lax.scan of 14 masked steps — each node advances in lockstep
with a 'stopped' flag.

bug_compat notes:
  * the pairwise endcap sigma-swap tests the X coordinate, not z
    (clustering.py:49-57 reads coords[0]) — reproduced under bug_compat;
  * the minimum is taken over NONZERO lower-triangle entries
    (clustering.py:119-120), reproduced exactly;
  * the KL distance uses the elementwise-product trace (clustering.py:93).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from gnn_track_finding.config import PipelineConfig
from gnn_track_finding.graph.state import GraphState
from gnn_track_finding.ops import gtools, linalg

KC = 16  # compact table width == reference's upper degree gate


def _member_slots(g: GraphState, member: jax.Array) -> jax.Array:
    """(N, K) membership flags of the in-edge table, built by SCATTER from
    the edge axis (one writer per real slot)."""
    tab = g.in_edges
    slots = jnp.zeros(tab.shape, bool).at[g.dst, g.slot_in].max(
        member & g.edge_mask)
    return slots & (tab >= 0)


def _compact_member_edges(g: GraphState, member_slot: jax.Array,
                          kc: int = KC) -> Tuple[jax.Array, jax.Array]:
    """First kc member in-edges per node, in insertion order.

    Returns (edge_idx (N, kc) int32 with -1 padding, member_count (N,)).

    Each member edge's compact position is its rank among the head's
    member in-edges (an inclusive cumsum over the slot table), and the
    compact table fills by an edge-space scatter — one writer per cell,
    no sort of the (N, K) table.
    """
    n = g.num_padded_nodes
    rank_slot = jnp.cumsum(member_slot, axis=1) - 1      # (N, K)
    rank_e = gtools.table_lookup(rank_slot, g.dst, g.slot_in)
    member_e = gtools.table_lookup(member_slot, g.dst, g.slot_in)
    # g.edge_mask is essential: padding edges are built with dst=0/slot_in=0
    # fill, so member_e above reads node 0 slot 0's membership for EVERY
    # padding edge — without the mask their (large) edge ids win the .max
    # scatter into compact[0, rank] and clobber the real edge id.
    ok = member_e & g.edge_mask & (rank_e >= 0) & (rank_e < kc)
    rows = jnp.where(ok, g.dst, n)
    cols = jnp.where(ok, rank_e, 0)
    edge_ids = jnp.arange(g.num_padded_edges, dtype=jnp.int32)
    compact = jnp.full((n, kc), -1, jnp.int32).at[rows, cols].max(
        jnp.where(ok, edge_ids, -1), mode="drop")
    count = jnp.sum(member_slot, axis=1)
    return compact, count


def _pairwise_chi2(node_xyzr: jax.Array, cfg: PipelineConfig, nb_xyzr: jax.Array,
                   valid: jax.Array, joint: jax.Array, jcov: jax.Array) -> jax.Array:
    """Masked (rows, KC, KC) lower-triangle chi2 matrix (clustering.py:11-86).

    nb_xyzr: (rows, KC, 4) neighbour coordinates as recorded in the state
    dict (seed-time or extrapolation-time snapshot); the node's own coords
    are always the immutable 'xyzr' attribute (clustering.py:217).
    Row-space: rows == N single-device, N/D on an owner shard."""
    dtype = node_xyzr.dtype

    # [a, b] block distance — componentwise (N,K,K) math, not an einsum
    # over 2-wide minor dims (see ops/linalg.py module doc)
    da = joint[:, :, None, 0] - joint[:, None, :, 0]              # (N,K,K)
    db = joint[:, :, None, 1] - joint[:, None, :, 1]
    pair = lambda q: q[:, :, None] + q[:, None, :]
    c00 = pair(jcov[:, :, 0, 0])
    c01 = pair(jcov[:, :, 0, 1])
    c10 = pair(jcov[:, :, 1, 0])
    c11 = pair(jcov[:, :, 1, 1])
    idet = 1.0 / (c00 * c11 - c01 * c10)
    d1 = (da * (c11 * da - c01 * db) + db * (c00 * db - c10 * da)) * idet

    # delta-tau term from raw coordinates
    x_a = node_xyzr[:, 0][:, None]
    z_a = node_xyzr[:, 2][:, None]
    r_a = node_xyzr[:, 3][:, None]
    x_n = nb_xyzr[..., 0]
    z_n = nb_xyzr[..., 2]
    r_n = nb_xyzr[..., 3]

    def sigmas(coord):
        endcap = jnp.abs(coord) >= cfg.endcap_boundary
        sz = jnp.where(endcap, cfg.sigma0rz, cfg.sigma0rz2).astype(dtype)
        sr = jnp.where(endcap, cfg.sigma0rz2, cfg.sigma0rz).astype(dtype)
        return sz, sr

    # endcap test coordinate: X under bug_compat (clustering.py:49-57), else z
    sza, sra = sigmas(x_a if cfg.bug_compat else z_a)
    szn, srn = sigmas(x_n if cfg.bug_compat else z_n)

    inv_b = 1.0 / (r_n - r_a)             # (N, K)
    tau = (z_n - z_a) * inv_b
    j2 = inv_b[:, :, None]                # for state i ("b")
    j3 = -inv_b[:, None, :]               # for state j ("c")
    j1 = -j3 - j2
    j5 = (-(z_n - z_a) * inv_b * inv_b)[:, :, None]
    j6 = ((z_n - z_a) * inv_b * inv_b)[:, None, :]
    j4 = -j5 - j6
    var_dt = (j1 * j1 * (sza * sza)[:, :, None]
              + j2 * j2 * (szn * szn)[:, :, None]
              + j3 * j3 * (szn * szn)[:, None, :]
              + j4 * j4 * (sra * sra)[:, :, None]
              + j5 * j5 * (srn * srn)[:, :, None]
              + j6 * j6 * (srn * srn)[:, None, :])
    d2 = (tau[:, :, None] - tau[:, None, :]) ** 2 / var_dt

    chi2 = d1 + d2
    k = valid.shape[1]
    tri = (jnp.arange(k)[:, None] > jnp.arange(k)[None, :])        # i > j
    ok = tri[None] & valid[:, :, None] & valid[:, None, :]
    return jnp.where(ok, chi2, jnp.inf)


def cluster(g: GraphState, cfg: PipelineConfig, use_updated: bool,
            kl_thresholds=None, kc: int = KC, axis_name=None,
            routing=None) -> GraphState:
    """One GMR clustering round over the whole graph.

    kl_thresholds: optional per-node (N,) KL acceptance thresholds from the
    calibration LUT (calib/lut.py).  The reference plumbs its LUT file into
    clustering but never reads it (clustering.py:386,400 — per-bin
    thresholds commented out in clustering_updated_states_test.py:176,233);
    passing them here enables the intended feature.  None -> the global
    scalar threshold from the config (run_gnn_trackml_mod.sh:89,112).

    axis_name/routing: edge-partitioned execution under shard_map
    (parallel/edge_shard.py).  Clustering is node-parallel but reads
    EDGE state through each node's in-edge table, so the designed
    exchange routes every edge's 29-float packed state row to its
    head-node's owner shard (the same all_to_all as
    priors.prior_reweight), the owner runs the GMR core on its N/D
    interleaved node rows, and only the narrow per-node results
    (found/merged state/prior: 14 floats) plus the (N, kc) deactivation
    verdicts are all_gathered back.  Requires the static OwnerRouting —
    the dense alternative (psum of the (cg, kc, 29) compact table) would
    move ~35 MB per round where the all_to_all moves each payload once.
    """
    member = (g.has_updated if use_updated else g.edge_mask) & g.edge_mask
    member_slot = _member_slots(g, member)
    packed = _packed_states(g, use_updated)
    chi2_thr, kl_thr = cfg.cluster_thresholds(use_updated)
    if kl_thresholds is not None:
        kl_thr = kl_thresholds

    if axis_name is not None:
        from gnn_track_finding.ops import collect
        assert routing is not None, (
            "edge-partitioned clustering needs the OwnerRouting exchange "
            "(parallel/edge_shard.build_owner_routing)")
        member_slot = collect.allor(member_slot, axis_name)
        gate = _gate(jnp.sum(member_slot, axis=1), cfg)
        return _cluster_sharded(g, cfg, packed, member_slot, gate,
                                chi2_thr, kl_thr, axis_name, routing, kc)

    tab, count = _compact_member_edges(g, member_slot, kc)
    gate = _gate(count, cfg)
    found, pm, pc, mprior, deact_slot = _cluster_core_xla(
        cfg, chi2_thr, kl_thr, g.xyzr, gate, tab >= 0,
        packed[jnp.maximum(tab, 0)], kc)
    return _apply_cluster_results(g, cfg, member_slot, found, pm, pc,
                                  mprior, deact_slot, kc)


def _gate(count, cfg: PipelineConfig):
    """The reference's degree gate 2 < d < 16 (clustering.py:207)."""
    return (count > cfg.cluster_min_edges - 1) & (count < cfg.cluster_max_edges + 1)


def _packed_states(g: GraphState, use_updated: bool) -> jax.Array:
    """(E, 29) per-edge state rows, gathered once per slot:
    [p_sv(3) | p_cov(9) | j_sv(3) | j_cov(9) | prior(1) | nb_xyzr(4)].

    Neighbour coordinates are the reference's in-dict 'xyzr' records
    (clustering.py:218): the seed-time snapshot (== static e_xyzr tail)
    for track_state_estimates, the extrapolation-time snapshot (upd_xyzr)
    for updated_track_states."""
    if use_updated:
        return jnp.concatenate([
            g.upd_sv, g.upd_cov.reshape(-1, 9), g.upd_joint,
            g.upd_joint_cov.reshape(-1, 9), g.upd_prior[:, None],
            g.upd_xyzr], axis=1)
    return jnp.concatenate([
        g.seed_sv, g.seed_cov.reshape(-1, 9), g.seed_joint,
        g.seed_joint_cov.reshape(-1, 9), g.seed_prior[:, None],
        g.e_xyzr[:, :4]], axis=1)


def _cluster_sharded(g: GraphState, cfg: PipelineConfig, packed: jax.Array,
                     member_slot: jax.Array, gate: jax.Array,
                     chi2_thr, kl_thr, axis_name, routing,
                     kc: int = KC) -> GraphState:
    """Edge-partitioned clustering round (see `cluster` docstring).

    Exchange census per round: one (N, K) u8 allor of the member table
    (done by the caller), one all_to_all of E_loc x 29 f32 payloads, one
    (N, 14) f32 + one (N, kc) u8 all_gather of results — never an
    edge-sized f32 all_gather (pinned in tests/test_edge_shard.py)."""
    from gnn_track_finding.ops import collect

    n = g.num_padded_nodes
    d = routing.n_shards
    rows = n // d
    dtype = g.dtype
    k_tab = g.in_edges.shape[1]
    w = packed.shape[1]

    # 1. route every edge's packed state row to its head's owner shard;
    #    non-member slots land in the table too but the rank compaction
    #    below never selects them
    recv = collect.route_to_owners(packed, routing.owner, routing.pos,
                                   routing.bucket, axis_name)  # (D, B, W)
    my = jax.lax.axis_index(axis_name)
    rr = jax.lax.dynamic_index_in_dim(routing.recv_row, my, 0,
                                      keepdims=False)          # (D, B)
    ss = jax.lax.dynamic_index_in_dim(routing.recv_slot, my, 0,
                                      keepdims=False)
    slot_tab = jnp.zeros((rows, k_tab, w), dtype).at[
        jnp.where(rr >= 0, rr, rows), ss].set(recv, mode="drop")

    # 2. owner-side row blocks of the replicated node-space inputs
    mem_own = collect.owner_block_interleaved(member_slot, axis_name)
    gate_own = collect.owner_block_interleaved(gate, axis_name)
    xyzr_own = collect.owner_block_interleaved(g.xyzr, axis_name)
    kl_own = (kl_thr if jnp.ndim(kl_thr) == 0
              else collect.owner_block_interleaved(kl_thr, axis_name))

    # 3. compact the K-wide slot table to the kc-wide rank table: member
    #    slots to the front in slot order (an exact row gather)
    pk, valid_c = gtools.compact_rows(mem_own, slot_tab, kc)

    # 4. the GMR core on the owner's N/D rows
    found_o, pm_o, pc_o, mprior_o, deact_o = _cluster_core_xla(
        cfg, chi2_thr, kl_own, xyzr_own, gate_own, valid_c, pk, kc)

    # 5. all_gather the narrow results; owner-major -> node order is the
    #    static interleaving permutation (node i <-> owner-major row
    #    (i % D) * rows + i // D)
    res_own = jnp.concatenate([
        found_o[:, None].astype(dtype), pm_o, pc_o.reshape(rows, 9),
        mprior_o[:, None]], axis=1)                            # (rows, 14)
    res_full = collect.gather_rows(res_own, axis_name)         # (N, 14)
    deact_full = collect.gather_rows(
        deact_o.astype(jnp.uint8), axis_name) > 0              # (N, kc)
    perm = (jnp.arange(n, dtype=jnp.int32) % d) * rows + (
        jnp.arange(n, dtype=jnp.int32) // d)
    res = res_full[perm]
    deact_slot = deact_full[perm]
    return _apply_cluster_results(
        g, cfg, member_slot, res[:, 0] > 0.5, res[:, 1:4],
        res[:, 4:13].reshape(n, 3, 3), res[:, 13], deact_slot, kc)


def _cluster_core_xla(cfg: PipelineConfig, chi2_thr, kl_thr,
                      node_xyzr: jax.Array, gate: jax.Array,
                      valid: jax.Array, pk: jax.Array, kc: int = KC):
    """Row-space GMR core (masked batched ops + 14-step scan).

    pk: (rows, kc, 29) packed per-slot state rows (layout in `cluster`);
    rows is the full node axis single-device or an owner shard's N/D
    block under the edge partition (cluster's sharded path).  Returns
    (found, pm, pc, mprior, deact_slot) in row space."""
    dtype = node_xyzr.dtype
    p_sv = pk[..., 0:3]
    p_cov = pk[..., 3:12].reshape(*pk.shape[:2], 3, 3)
    j_sv = pk[..., 12:15]
    j_cov = pk[..., 15:24].reshape(*pk.shape[:2], 3, 3)
    prior = pk[..., 24]
    nb_xyzr = pk[..., 25:29]

    eye = jnp.eye(3, dtype=dtype)
    safe = lambda c: jnp.where(valid[:, :, None, None], c, eye)
    p_cov = safe(p_cov)
    j_cov = safe(j_cov)

    chi2 = _pairwise_chi2(node_xyzr, cfg, nb_xyzr, valid, j_sv, j_cov)
    # min over nonzero entries (clustering.py:119-120)
    chi2 = jnp.where(chi2 == 0.0, jnp.inf, chi2)
    flat = chi2.reshape(chi2.shape[0], -1)
    best = jnp.argmin(flat, axis=1)
    best_val = jnp.min(flat, axis=1)   # == flat[best] without the gather
    i0 = best // kc
    i1 = best % kc
    found = gate & (best_val < chi2_thr) & jnp.isfinite(best_val)

    # one-hot select over the kc axis instead of minor-axis take_along_axis
    ar_kc = jnp.arange(kc)[None, :]

    def take(arr, idx):
        oh = (ar_kc == idx[:, None]).reshape(
            arr.shape[:2] + (1,) * (arr.ndim - 2))
        return jnp.sum(jnp.where(oh, arr, 0), axis=1)
    pm, pc = linalg.merge_gaussians(take(p_sv, i0), take(p_cov, i0),
                                    take(p_sv, i1), take(p_cov, i1))
    jm, jc = linalg.merge_gaussians(take(j_sv, i0), take(j_cov, i0),
                                    take(j_sv, i1), take(j_cov, i1))
    mprior = take(prior, i0) + take(prior, i1)

    ar = jnp.arange(kc)[None, :]
    absorbed = (ar == i0[:, None]) | (ar == i1[:, None])
    remaining = valid & ~absorbed

    def step(carry, _):
        pm, pc, jm, jc, mprior, remaining, stopped = carry
        kl = linalg.kl_distance(j_sv, j_cov, jm[:, None], jc[:, None],
                                bug_compat=cfg.bug_compat)
        kl = jnp.where(remaining, kl, jnp.inf)
        k_best = jnp.argmin(kl, axis=1)
        k_val = jnp.min(kl, axis=1)    # == kl[k_best] without the gather
        do = (~stopped) & (k_val < kl_thr) & jnp.isfinite(k_val)

        npm, npc = linalg.merge_gaussians(take(p_sv, k_best), take(p_cov, k_best), pm, pc)
        njm, njc = linalg.merge_gaussians(take(j_sv, k_best), take(j_cov, k_best), jm, jc)
        nprior = take(prior, k_best) + mprior

        d = do[:, None]
        pm = jnp.where(d, npm, pm)
        pc = jnp.where(do[:, None, None], npc, pc)
        jm = jnp.where(do[:, None], njm, jm)
        jc = jnp.where(do[:, None, None], njc, jc)
        mprior = jnp.where(do, nprior, mprior)
        remaining = remaining & ~(d & (ar == k_best[:, None]))
        stopped = stopped | ~do
        return (pm, pc, jm, jc, mprior, remaining, stopped), None

    init = (pm, pc, jm, jc, mprior, remaining, ~found)
    (pm, pc, jm, jc, mprior, remaining, _), _ = jax.lax.scan(
        step, init, None, length=kc - 2)

    deact_slot = remaining & found[:, None]              # (rows, kc)
    return found, pm, pc, mprior, deact_slot


def _apply_cluster_results(g: GraphState, cfg: PipelineConfig,
                           member_slot, found, pm, pc, mprior, deact_slot,
                           kc: int = KC) -> GraphState:
    """Write merged states and apply the simultaneous edge deactivation.

    Each member edge reads its verdict back through its rank among the
    head's member in-edges (gather via slot_in, no scatter): the compact
    table position of a member edge equals that rank (stable compaction).
    """
    has_merged = g.has_merged | found
    merged_state = jnp.where(found[:, None], pm, g.merged_state)
    merged_cov = jnp.where(found[:, None, None], pc, g.merged_cov)
    merged_prior = jnp.where(found, mprior, g.merged_prior)

    member_e = gtools.table_lookup(member_slot, g.dst, g.slot_in)
    rank_slot = jnp.cumsum(member_slot, axis=1) - 1      # (N, K)
    rank_e = gtools.table_lookup(rank_slot, g.dst, g.slot_in)
    in_compact = member_e & (rank_e >= 0) & (rank_e < kc)
    deact = in_compact & gtools.table_lookup(
        deact_slot, g.dst, jnp.clip(rank_e, 0, kc - 1))
    deact = deact & g.edge_mask

    return g.replace(
        has_merged=has_merged, merged_state=merged_state,
        merged_cov=merged_cov, merged_prior=merged_prior,
        active=g.active & ~deact,
    )
