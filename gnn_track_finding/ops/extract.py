"""Track-candidate extraction as batched device kernels.

Re-design of extract_track_candidates.py:42-517.  The reference walks each
pickled subgraph, splits on deactivated edges with NetworkX CCA
(:332-346), then per candidate: fragment gate (:415), close-proximity
same-layer node merging (:58-151), one-hit-per-layer check (:427-429),
radius sort + innermost-edge rotation (:172-193,433-438), and a sequential
two-plane Kalman track fit with Ornstein-Uhlenbeck process noise and
Moliere multiple scattering whose summed chi2 becomes a p-value gate
(:209-328,442-447).

Device mapping: CCA is min-label propagation (graph/cca.py); every component
becomes a row of a (N, H) candidate matrix built by a lexsort on
(component, -r) — hits arrive already radius-sorted; the proximity merge is
a masked H x H duplicate analysis; both Kalman fits run as ONE lax.scan of
H-1 steps over all candidates simultaneously; p-values use the regularised
incomplete gamma function (chi2 survival function).

bug_compat reproduces the rotation typo at :190-191 (r_new mixes r with r,
z_new mixes z with z instead of rotating (z, r) jointly) and filterpy's
scalar-Q broadcast in the zr fit (:302: Q added to every covariance entry).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.scipy.special import gammaincc

from gnn_track_finding.config import PipelineConfig
from gnn_track_finding.graph.state import GraphState
from gnn_track_finding.graph import cca
from gnn_track_finding.ops import gtools, linalg


class ExtractionResult(NamedTuple):
    labels: jax.Array        # (N,) component label per node (this round's CCA)
    row_of_node: jax.Array   # (N,) candidate row per node, -1 if none
    cand_nodes: jax.Array    # (C, H) node indices per candidate row, -1 pad
    cand_size: jax.Array     # (C,) nodes in the candidate (pre-merge)
    processed: jax.Array     # (C,) candidate reached the KF fit
    accepted: jax.Array      # (C,) passed both p-value gates
    merged_pair: jax.Array   # (C,) number of proximity-merged node pairs
    pval_xy: jax.Array       # (C,)
    pval_zr: jax.Array       # (C,)
    # accepted rows compacted to the front (device-side argsort) so the
    # host driver pulls only acc_count rows instead of the full (C, H)
    # matrix
    acc_nodes: jax.Array     # (C, H) accepted-first node indices
    acc_pvals: jax.Array     # (C, 2) accepted-first (pval_xy, pval_zr)
    acc_count: jax.Array     # ()    number of accepted rows


def _candidate_matrix(g: GraphState, labels: jax.Array, h: int,
                      min_hits: int, label_ok=None, sizes=None):
    """Compacted rows of node indices per eligible component
    (size in [min_hits, h]), radius-descending within a row (ref :433-436).

    C = N // min_hits + 1 is a hard upper bound on the number of eligible
    components, so the row space is ~min_hits-fold smaller than N.

    label_ok / sizes: from cca.connected_components_gated — labels with
    crossing active edges (necessarily fragments of oversized components)
    are excluded from eligibility, and the per-label sizes are reused
    instead of recomputed.
    """
    n = g.num_padded_nodes
    # rounded up to a multiple of 64 so C-sized arrays (accepted, pvals)
    # take gather1d's blocked fast path downstream; the last row stays the
    # scatter dump (legit rows never exceed n // min_hits - 1)
    c = -(-(n // min_hits + 1) // 64) * 64
    alive = g.node_mask
    big = jnp.int32(n)
    lab = jnp.where(alive, labels, big)

    if sizes is None:
        sizes = jax.ops.segment_sum(alive.astype(jnp.int32), lab, n + 1)[:n]
    eligible = (sizes >= min_hits) & (sizes <= h)
    if label_ok is not None:
        eligible = eligible & label_ok
    size_by_label = sizes
    row_of_label = jnp.cumsum(eligible.astype(jnp.int32)) - 1
    row_of_label = jnp.where(eligible, row_of_label, -1)    # (N,)

    order = jnp.lexsort((-g.xyzr[:, 3], lab))
    # packed row gather for the per-position data after the sort
    lab_row = jnp.stack([lab, jnp.arange(n, dtype=jnp.int32)], axis=1)[order]
    sorted_lab = lab_row[:, 0]
    # within-segment position via a scan (no label-indexed gather needed)
    pos_all = jnp.arange(n, dtype=jnp.int32)
    change = jnp.concatenate([jnp.array([True]),
                              sorted_lab[1:] != sorted_lab[:-1]])
    seg_start = jax.lax.cummax(jnp.where(change, pos_all, 0))
    pos = pos_all - seg_start

    sorted_row = jnp.where(
        sorted_lab < big,
        gtools.gather1d(row_of_label, jnp.minimum(sorted_lab, n - 1)), -1)
    ok = (sorted_row >= 0) & (pos < h)
    mat = jnp.full((c, h), -1, jnp.int32)
    rows = jnp.where(ok, sorted_row, c - 1)
    cols = jnp.where(ok, pos, 0)
    mat = mat.at[rows, cols].max(jnp.where(ok, lab_row[:, 1], -1))

    size = jnp.zeros((c,), jnp.int32).at[
        jnp.where(eligible, row_of_label, c - 1)].max(
        jnp.where(eligible, size_by_label[:n], 0))
    row_of_node = jnp.where(
        alive, gtools.gather1d(row_of_label, jnp.minimum(lab, n - 1)), -1)
    return mat, size, row_of_node


def _proximity_merge(g: GraphState, cfg: PipelineConfig, mat: jax.Array,
                     size: jax.Array):
    """Close-proximity same-layer merge analysis (ref :58-151).

    Returns (coords (C,H,4) post-merge, valid (C,H), can_process (C,),
    n_pairs (C,)).  A candidate 'can process' when after merging (if any)
    every layer holds exactly one hit: either it had no duplicated layers,
    or <= 2 layers held exactly 2 hits each within the merge distance and
    the rest one.
    """
    c, h = mat.shape
    valid = mat >= 0
    node = jnp.maximum(mat, 0)
    coords = jnp.where(valid[..., None], g.xyzr[node], 0.0)
    vivl = g.vivl[node]
    key = jnp.where(valid, vivl[..., 0] * 1000 + vivl[..., 1], -1 - jnp.arange(h)[None])

    same = (key[:, :, None] == key[:, None, :])          # (C,H,H)
    freq = jnp.sum(same & valid[:, None, :], axis=2)
    freq = jnp.where(valid, freq, 0)
    earlier = jnp.tril(jnp.ones((h, h), bool), k=-1)     # j < i
    dup_before = jnp.any(same & earlier[None], axis=2)
    is_first = valid & ~dup_before

    has2 = jnp.any(freq == 2, axis=1)
    layers_with_2 = jnp.sum(is_first & (freq == 2), axis=1)
    has_ge3 = jnp.any(freq >= 3, axis=1)

    # partner of each first-occurrence duplicate (the later same-key slot).
    # One-hot contraction over the (C,H,H) same-key mask instead of
    # argmax + minor-axis take_along_axis; for freq==2 rows exactly one
    # later slot matches, so the masked sum IS the partner's coords.
    later = earlier.T
    pair_mask = same & later[None]                       # (C,H,H)
    pair_lead = is_first & (freq == 2)
    p_coords = jnp.sum(
        jnp.where(pair_mask[..., None], coords[:, None, :, :], 0.0), axis=2)
    d3 = jnp.sqrt(jnp.sum((coords[..., :3] - p_coords[..., :3]) ** 2, axis=2))
    pairs_ok = jnp.all(jnp.where(pair_lead, d3 <= cfg.node_merge_distance, True),
                       axis=1)

    mergeable = has2 & (layers_with_2 <= 2) & ~has_ge3 & pairs_ok
    clean = ~jnp.any(freq >= 2, axis=1)
    can_process = clean | mergeable

    # apply midpoint merge on mergeable rows (ref :48-55,109-132)
    mid_xyz = 0.5 * (coords[..., :3] + p_coords[..., :3])
    mid_r = jnp.sqrt(mid_xyz[..., 0] ** 2 + mid_xyz[..., 1] ** 2)
    mid = jnp.concatenate([mid_xyz, mid_r[..., None]], axis=-1)
    do_merge = mergeable[:, None] & pair_lead
    coords = jnp.where(do_merge[..., None], mid, coords)
    # invalidate the partner slot: a slot j dies when some merged lead i
    # has it as its later same-key partner (mask any-reduce, no scatter)
    kill = jnp.any(pair_mask & do_merge[:, :, None], axis=1)
    valid_m = valid & ~kill
    n_pairs = jnp.where(mergeable, layers_with_2, 0)
    return coords, valid_m, can_process, n_pairs


def _rotate_tracks(coords, valid, n_hits, cfg: PipelineConfig):
    """Innermost-edge rotation (ref :172-193); hits are radius-descending so
    the innermost hits sit at positions n-1, n-2, n-3."""
    c, h, _ = coords.shape
    idx_last = jnp.maximum(n_hits - 1, 0)
    idx_2 = jnp.maximum(n_hits - 2, 0)
    idx_3 = jnp.maximum(n_hits - 3, 0)
    # one-hot select over the H axis instead of minor-axis take_along_axis
    # (the one-hot reduce fuses into its consumer)
    slot = jnp.arange(h)
    take = lambda i: jnp.sum(
        jnp.where((slot[None, :] == i[:, None])[..., None], coords, 0.0),
        axis=1)
    p1 = take(idx_last)
    p2a = take(idx_2)
    p3 = take(idx_3)
    d = jnp.sqrt(jnp.sum((p1[:, :3] - p2a[:, :3]) ** 2, axis=1))
    p2 = jnp.where((d < cfg.separation_3d_threshold)[:, None], p3, p2a)

    angle_xy = jnp.arctan2(p2[:, 1] - p1[:, 1], p2[:, 0] - p1[:, 0])
    angle_zr = jnp.arctan2(p2[:, 2] - p1[:, 2], p2[:, 3] - p1[:, 3])
    cxy, sxy = jnp.cos(angle_xy)[:, None], jnp.sin(angle_xy)[:, None]
    czr, szr = jnp.cos(angle_zr)[:, None], jnp.sin(angle_zr)[:, None]
    x, y, z, r = (coords[..., i] for i in range(4))
    xn = x * cxy + y * sxy
    yn = -x * sxy + y * cxy
    if cfg.bug_compat:
        rn = r * czr + r * szr       # ref :190 typo kept
        zn = -z * szr + z * czr      # ref :191 typo kept
    else:
        rn = r * czr + z * szr
        zn = -z * szr + r * czr
    out = jnp.stack([xn, yn, zn, rn], axis=-1)
    return jnp.where(valid[..., None], out, 0.0)


def _kf_fit(coords, valid, n_hits, cfg: PipelineConfig):
    """Batched two-plane Kalman track fit (ref :209-328) -> p-values."""
    c, h, _ = coords.shape
    dtype = coords.dtype
    sxy2 = cfg.sigma0xy ** 2
    srz2 = cfg.sigma0rz ** 2

    y0 = coords[:, 0, 1]
    r0 = coords[:, 0, 3]
    x_xy = jnp.stack([y0, jnp.zeros_like(y0), jnp.zeros_like(y0)], axis=1)
    P_xy = jnp.tile(jnp.diag(jnp.array([sxy2, 1.0, 1.0], dtype)), (c, 1, 1))
    x_rz = jnp.stack([r0, jnp.zeros_like(r0)], axis=1)
    P_rz = jnp.tile(jnp.array([[srz2, 0.0], [0.0, 1000.0]], dtype), (c, 1, 1))

    def step(carry, xs):
        x_xy, P_xy, x_rz, P_rz, chi_xy, chi_rz = carry
        i, p2, p3 = xs
        ok = (i + 1 < n_hits)
        x2, y2, z2, r2 = (p2[:, k] for k in range(4))
        x3, y3, z3, r3 = (p3[:, k] for k in range(4))

        # parabola through origin + both hits (ref :197-205,236-239)
        denom = (0.0 - x2) * (0.0 - x3) * (x2 - x3)
        denom = jnp.where(denom == 0.0, linalg.tiny(dtype), denom)
        a = (x3 * y2 - x2 * y3) / denom
        b = (-(x3 ** 2) * y2 + (x2 ** 2) * y3) / denom

        dr = r3 - r2
        dz = z3 - z2
        hyp = jnp.sqrt(dr * dr + dz * dz)
        sin_t = jnp.abs(dr) / jnp.maximum(hyp, linalg.tiny(dtype))
        kappa = (2.0 * a) / (1.0 + (2.0 * a * x3 + b) ** 2) ** 1.5
        var_ms = sin_t * cfg.ms_coefficient() * kappa * kappa
        endcap = jnp.abs(z3) >= cfg.endcap_boundary
        var_ms = jnp.where(endcap, var_ms * jnp.abs(dr / jnp.where(dz == 0, linalg.tiny(dtype), dz)),
                           var_ms)

        # OU transition + process noise (ref :257-282)
        dx = x3 - x2
        e1 = jnp.exp(-jnp.abs(dx) * cfg.ou_alpha)
        f1 = (1.0 - e1) / cfg.ou_alpha
        g1 = (jnp.abs(dx) - f1) / cfg.ou_alpha
        sw2 = cfg.ou_sigma ** 2
        st2 = var_ms
        dx2 = dx * dx
        dxw2 = dx2 * sw2
        q02 = 0.5 * dxw2
        q01 = dx * (st2 + q02)
        q12 = dx * sw2
        one = jnp.ones_like(dx)
        zero = jnp.zeros_like(dx)
        F = jnp.stack([
            jnp.stack([one, dx, g1], axis=-1),
            jnp.stack([zero, one, f1], axis=-1),
            jnp.stack([zero, zero, e1], axis=-1)], axis=-2)
        Q = jnp.stack([
            jnp.stack([dx2 * (st2 + 0.25 * dxw2), q01, q02], axis=-1),
            jnp.stack([q01, st2 + dxw2, q12], axis=-1),
            jnp.stack([q02, q12, sw2 * one], axis=-1)], axis=-2)

        xp = linalg.mat3_vec(F, x_xy)
        Pp = linalg.sandwich3(F, P_xy) + Q
        # Joseph update, H = [1, 0, 0]
        Sk = Pp[:, 0, 0] + sxy2
        K = Pp[:, :, 0] / Sk[:, None]
        res = y3 - xp[:, 0]
        xn = xp + K * res[:, None]
        ikh = jnp.eye(3, dtype=dtype) - K[:, :, None] * jnp.array(
            [1.0, 0.0, 0.0], dtype)[None, None, :]
        Pn = linalg.sandwich3(ikh, Pp) + sxy2 * K[:, :, None] * K[:, None, :]
        res_post = y3 - xn[:, 0]
        S_post = Pn[:, 0, 0] + sxy2
        c_xy = res_post * res_post / S_post

        # zr plane: tracks r over dz steps, scalar-Q broadcast (ref :299-316)
        Frz = jnp.stack([
            jnp.stack([one, dz], axis=-1),
            jnp.stack([zero, one], axis=-1)], axis=-2)
        xrp = linalg.mat2_vec(Frz, x_rz)
        Prp = linalg.sandwich2(Frz, P_rz)
        if cfg.bug_compat:
            Prp = Prp + var_ms[:, None, None]     # filterpy scalar broadcast
        else:
            Prp = Prp.at[:, 1, 1].add(var_ms)
        Srz = Prp[:, 0, 0] + srz2
        Krz = Prp[:, :, 0] / Srz[:, None]
        res_rz = r3 - xrp[:, 0]
        xrn = xrp + Krz * res_rz[:, None]
        ikh2 = jnp.eye(2, dtype=dtype) - Krz[:, :, None] * jnp.array(
            [1.0, 0.0], dtype)[None, None, :]
        Prn = linalg.sandwich2(ikh2, Prp) + srz2 * Krz[:, :, None] * Krz[:, None, :]
        res_rz_post = r3 - xrn[:, 0]
        S_rz_post = Prn[:, 0, 0] + srz2
        c_rz = res_rz_post * res_rz_post / S_rz_post

        sel = ok[:, None]
        selm = ok[:, None, None]
        carry = (jnp.where(sel, xn, x_xy), jnp.where(selm, Pn, P_xy),
                 jnp.where(sel, xrn, x_rz), jnp.where(selm, Prn, P_rz),
                 chi_xy + jnp.where(ok, c_xy, 0.0),
                 chi_rz + jnp.where(ok, c_rz, 0.0))
        return carry, None

    init = (x_xy, P_xy, x_rz, P_rz,
            jnp.zeros((c,), dtype), jnp.zeros((c,), dtype))
    # hit pairs ride the scan's xs (hit-major (H, C, 4) layout) instead of
    # per-step dynamic slices of the candidate-major matrix; FULL unroll
    # turns the 31 tiny steps into one straight-line kernel (each step is
    # ~100 vector ops on (C,) lanes — launch-, not bandwidth-, bound)
    ps = jnp.swapaxes(coords, 0, 1)                   # (H, C, 4)
    xs = (jnp.arange(h - 1), ps[:-1], ps[1:])
    (x_xy, P_xy, x_rz, P_rz, chi_xy, chi_rz), _ = jax.lax.scan(
        step, init, xs, unroll=True)

    dof = jnp.maximum(n_hits - 2, 1).astype(dtype)
    pval_xy = gammaincc(0.5 * dof, 0.5 * chi_xy)
    pval_zr = gammaincc(0.5 * dof, 0.5 * chi_rz)
    return pval_xy, pval_zr


def extract_candidates(g: GraphState, cfg: PipelineConfig, labels=None,
                       axis_name=None):
    """One extraction round -> ExtractionResult.

    labels: optional precomputed CCA labels (min node id per weak component
    over active edges).  The host driver passes labels from the native
    union-find (data/native_loader.connected_components_native, one linear
    pass) — far cheaper than the device label-propagation loop, which is
    used when labels is None (pure-jit contexts: benchmarks, dry runs,
    sharded batches).  Node/edge removal is applied separately via
    `apply_extraction` so results can be inspected host-side first.

    axis_name: edge-partitioned execution — only the CCA touches edge
    arrays (per-round (N,) pmin hook combine, graph/cca.py); the
    candidate matrix, proximity merge and KF fit are node/candidate-space
    work that every shard computes identically on replicated inputs.
    """
    h = cfg.max_track_hits
    label_ok = sizes = None
    if labels is None:
        # adaptive FastSV to full convergence: its while_loop exits early
        # on the sparser later extractions, while the fixed-round gated
        # variant (cca.connected_components_gated) always pays 5 rounds
        # plus a settledness tail (two edge-sized crossing scatters).
        labels = cca.connected_components_fastsv(
            g, g.edge_mask & g.active, axis_name=axis_name)
    mat, size, row_of_node = _candidate_matrix(g, labels, h,
                                               cfg.min_track_hits,
                                               label_ok, sizes)
    big_enough = size >= cfg.min_track_hits   # eligibility pre-filtered

    coords, valid_m, can_process, n_pairs = _proximity_merge(g, cfg, mat, size)
    n_hits = jnp.sum(valid_m, axis=1)
    # one hit per layer post-merge AND enough distinct layers (ref :427-429)
    processed = big_enough & can_process & (n_hits >= cfg.min_track_hits)

    # compact each row: push invalid slots to the end, radius order kept
    # (a row gather: every output is exactly one coordinate)
    coords_c, valid_c = gtools.compact_rows(valid_m, coords, valid_m.shape[1])

    coords_r = _rotate_tracks(coords_c, valid_c, n_hits, cfg)
    pval_xy, pval_zr = _kf_fit(coords_r, valid_c, n_hits, cfg)

    accepted = (processed & (pval_xy >= cfg.track_acceptance_pval)
                & (pval_zr >= cfg.track_acceptance_pval))
    # accepted-first compaction as a rank scatter (a permutation, every
    # destination unique) — same stable order as argsort(~accepted) without
    # the sort
    n_acc = jnp.sum(accepted)
    dest = jnp.where(accepted, jnp.cumsum(accepted) - 1,
                     n_acc + jnp.cumsum(~accepted) - 1).astype(jnp.int32)
    acc_nodes = jnp.zeros_like(mat).at[dest].set(mat)
    acc_pvals = jnp.zeros((mat.shape[0], 2), pval_xy.dtype).at[dest].set(
        jnp.stack([pval_xy, pval_zr], axis=1))
    return ExtractionResult(
        labels=labels, row_of_node=row_of_node, cand_nodes=mat,
        cand_size=size, processed=processed, accepted=accepted,
        merged_pair=n_pairs, pval_xy=pval_xy, pval_zr=pval_zr,
        acc_nodes=acc_nodes, acc_pvals=acc_pvals,
        acc_count=jnp.sum(accepted))


def apply_extraction(g: GraphState, res: ExtractionResult,
                     cfg: PipelineConfig) -> GraphState:
    """Remove accepted candidates' nodes, then drop whole ingest components
    that fell below the fragment size (ref :459-467)."""
    n = g.num_padded_nodes
    row = res.row_of_node
    node_extracted = ((row >= 0)
                      & gtools.gather1d(res.accepted, jnp.maximum(row, 0))
                      & g.node_mask)
    mask1 = g.node_mask & ~node_extracted
    # fragment classification at the granularity of the original component
    # masked-out nodes contribute 0 regardless of bin, so clamp them to
    # bin 0 and keep `left` at length n (a multiple of 64: the gather
    # below then takes the blocked fast path)
    comp = jnp.where(mask1, g.component, 0)
    left = jax.ops.segment_sum(mask1.astype(jnp.int32), comp, n)
    frag = gtools.gather1d(left, g.component) < cfg.min_track_hits
    new_node_mask = mask1 & ~frag
    # endpoint-alive test on undirected PAIRS: edge 2i+1 is edge 2i's
    # reverse (build layout), so mask[src]&mask[dst] is pair-symmetric —
    # gather at the even half only and mirror (halves the edge-sized
    # gather traffic)
    alive_pair = (gtools.gather1d(new_node_mask, g.src[0::2])
                  & gtools.gather1d(new_node_mask, g.dst[0::2]))
    alive_e = jnp.repeat(alive_pair, 2, total_repeat_length=g.src.shape[0])
    new_edge_mask = g.edge_mask & alive_e
    return g.replace(node_mask=new_node_mask, edge_mask=new_edge_mask,
                     active=g.active & new_edge_mask)
