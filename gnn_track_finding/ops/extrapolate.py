"""Message passing: Kalman extrapolation of merged states along edges.

Re-design of extrapolate_merged_states.py:26-518 as one edge-parallel
kernel.  For every directed edge e = (n -> m) whose tail n has a merged
state and whose 'activated' flag is set at stage start, the merged
parabolic state is transported into n's local frame evaluated at m via the
s*-substitution coordinate change (ref :40-79), with the full 3x3 analytic
Jacobian F (ref :81-110).  A chi2 gate on the transported c-parameter
against the (zero-by-construction) local measurement (ref :132-140,297-298)
either deactivates the edge (ref :387-402) or runs a Kalman
predict/update and stores the updated state ON the edge — the reference
writes it into the head node's 'updated_track_states' dict keyed by the
tail (ref :441-447).

Sequential-semantics reproduction (bug_compat):
  * ref :127-128 adds var_ms to the tail's stored merged_cov IN PLACE, so
    the k-th processed out-edge of n sees merged_cov plus the cumulative
    var_ms of out-edges 0..k (in adjacency insertion order, active only).
    Here that is an inclusive masked cumsum over the (N, K) out-edge table.
  * ref :306-322 initialises the filter at the ALREADY extrapolated state
    with transition F, so predict applies F a second time.
  * ref :362-365 aliases the joint covariance onto the updated covariance
    (third row/column zeroed on both).
  * ref :384 takes the updated state's mixture weight from the REVERSE
    edge's seed state (the tail's estimate keyed by the head).
In clean mode the cumsum becomes the single per-edge var_ms, predict is a
pure transport (F applied once), and the covariances are separate.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from gnn_track_finding.config import PipelineConfig
from gnn_track_finding.graph.state import GraphState
from gnn_track_finding.ops import collect, gtools, linalg
from gnn_track_finding.ops.seeding import rz_sigmas


def _jacobian_and_transport(a, b, c, x_A, sp, cp):
    """Frame-changed parabola parameters and Jacobian F (ref :63-110).

    Division/power-light formulation: each distinct denominator is
    inverted once and its powers are built by multiplication; `x ** 1.5`
    forms run as rsqrt products.  Same values to ~1 ulp.  (The dominant
    cost of this stage is elsewhere — see ops/linalg.py on einsum
    lowering — but the cheap algebra keeps the fused elementwise chain
    short.)
    """
    # den1 == the reference's vx == cp + b*sp; numer == x_p
    numer = x_A + c * sp
    inv1 = 1.0 / (cp + b * sp)
    inv1_2 = inv1 * inv1
    inv1_3 = inv1_2 * inv1
    s_star = -numer * (2.0 + (a * sp) * numer * inv1_2) * 0.5 * inv1

    asp = a * sp
    ds_da = -(sp * numer * numer) * inv1_3
    ds_db = (sp * numer * (1.0 + 3.0 * asp * numer * inv1_2)) * inv1_2
    ds_dc = -sp * (1.0 + 2.0 * asp * numer * inv1_2) * inv1

    inv2 = 1.0 / (cp + (2.0 * a + b) * sp)
    inv2_3 = inv2 * inv2 * inv2
    inv2_4 = inv2_3 * inv2
    da_da = inv2_3 * (1.0 - (6.0 * asp) * (s_star + a * ds_da) * inv2)
    da_db = (-3.0 * asp * (2.0 * a * ds_db + 1.0)) * inv2_4
    da_dc = (-6.0 * sp * ds_dc * a * a) * inv2_4

    tas = 2.0 * a * s_star + b
    inv3 = 1.0 / (cp + tas * sp)
    br3 = (cp - (sp * (-sp + tas * cp)) * inv3) * inv3
    db_da = 2.0 * (s_star + a * ds_da) * br3
    db_db = (1.0 + 2.0 * a * ds_da) * br3   # ds_da: ref :98 quirk
    db_dc = 2.0 * a * ds_dc * br3

    br4 = cp * (2.0 * a + b) - sp
    dc_da = ds_da * br4 + s_star * s_star * cp
    dc_db = ds_db * br4 + s_star * cp
    dc_dc = ds_dc * br4 + cp

    F = jnp.stack([
        jnp.stack([da_da, da_db, da_dc], axis=-1),
        jnp.stack([db_da, db_db, db_dc], axis=-1),
        jnp.stack([dc_da, dc_db, dc_dc], axis=-1),
    ], axis=-2)
    return F


def message_passing(g: GraphState, cfg: PipelineConfig,
                    return_debug: bool = False, axis_name=None):
    """One extrapolation round; returns the graph with per-edge updated
    states, chi2-failed edges deactivated, and (bug_compat) the tails'
    merged covariances advanced by their accumulated var_ms.

    return_debug=True additionally returns (chi2, processed_mask) — the
    optional off-critical-path analog of the reference's side-channel
    chi2-vs-truth CSV appends (extrapolate_merged_states.py:284-295),
    consumed by ops/metrics.chi2_truth_dump.

    axis_name: mesh axis of the shard_map edge partition
    (parallel/edge_shard.py).  Edge arrays arrive as local shards; node
    arrays and the (N, K) tables are replicated, so the only cross-shard
    traffic is the psum-combine of the out-table activity scatter below."""
    dtype = g.dtype

    # one packed row gather for everything node-dynamic at the tail:
    # [merged_state(3) | merged_cov(9) | has_merged(1) | gnn_xyzr(4)].
    # Coordinates ride the LIVE GNN view (g.gnn_xyzr), not the static
    # e_xyzr cache: the reference reads GNN_Measurement.x/... here
    # (extrapolate_merged_states.py:31-39), which extraction's
    # close-proximity merge mutates in place (see GraphState.gnn_xyzr).
    packed = jnp.concatenate([
        g.merged_state, g.merged_cov.reshape(-1, 9),
        g.has_merged[:, None].astype(dtype), g.gnn_xyzr], axis=1)
    pe = packed[g.src]                                  # (E, 17)
    merged = pe[:, :3]
    merged_cov_src = pe[:, 3:12].reshape(-1, 3, 3)
    a, b, c = merged[:, 0], merged[:, 1], merged[:, 2]
    tail_xyzr = pe[:, 13:17]
    nx_, ny_, nz_, nr_ = (tail_xyzr[:, i] for i in range(4))     # tail
    head_xyzr = g.gnn_xyzr[g.dst]                       # (E, 4)
    mx_, my_, mz_, mr_ = (head_xyzr[:, i] for i in range(4))     # head

    proc = g.edge_mask & g.active & (pe[:, 12] > 0.5)

    # --- multiple scattering per edge (ref :112-124; global head x) ---
    # kappa**2 needs (1+u^2)**-3: one rsqrt cubed instead of the exp/log
    # lowering of `** 1.5`.
    dr = mr_ - nr_
    dz = mz_ - nz_
    hyp = jnp.sqrt(dr * dr + dz * dz)
    sin_t = jnp.abs(dr) / jnp.maximum(hyp, linalg.tiny(dtype))
    u = 2.0 * a * mx_ + b
    rs = jax.lax.rsqrt(1.0 + u * u)
    kappa = (2.0 * a) * (rs * rs * rs)
    var_ms = sin_t * cfg.ms_coefficient() * kappa * kappa
    endcap_n = jnp.abs(nz_) >= cfg.endcap_boundary
    var_ms = jnp.where(endcap_n, var_ms * jnp.abs(dr) / jnp.abs(dz), var_ms)
    var_ms = jnp.where(proc, var_ms, 0.0)

    # --- cumulative in-place merged_cov mutation (ref :127-128) ---
    if cfg.bug_compat:
        # var_ms VALUES scatter from edge space into the out-table (one
        # writer per (node, slot); padding edges route out of bounds so
        # their zeros never race a real slot), instead of recomputing the
        # whole (N, K, 4) table's MS math.
        otab = g.out_edges
        if axis_name is None:
            row = jnp.where(proc, g.src, otab.shape[0])
            slot_ms = jnp.zeros(otab.shape, dtype).at[row, g.slot_out].set(
                var_ms, mode="drop")
        else:
            # sharded: exchange only the u8 activity flags and recompute
            # the MS table from replicated node data + the static head
            # cache — an f32 value-table psum would put the (N, K) table
            # back on the wire that the owner routing just removed
            proc_slot = collect.allor(
                jnp.zeros(otab.shape, bool).at[g.src, g.slot_out].max(
                    g.edge_mask & g.active),
                axis_name)
            proc_slot = proc_slot & g.has_merged[:, None] & (otab >= 0)
            head = g.out_head_xyzr                  # (N, K, 4) — refreshed
            # by the driver when extraction merges mutate GNN coordinates
            node_xyzr = g.gnn_xyzr
            a_n = g.merged_state[:, 0:1]
            b_n = g.merged_state[:, 1:2]
            dr_t = head[..., 3] - node_xyzr[:, 3:4]
            dz_t = head[..., 2] - node_xyzr[:, 2:3]
            hyp_t = jnp.sqrt(dr_t * dr_t + dz_t * dz_t)
            sin_t_t = jnp.abs(dr_t) / jnp.maximum(hyp_t, linalg.tiny(dtype))
            u_t = 2.0 * a_n * head[..., 0] + b_n
            rs_t = jax.lax.rsqrt(1.0 + u_t * u_t)
            kappa_t = (2.0 * a_n) * (rs_t * rs_t * rs_t)
            vms_t = sin_t_t * cfg.ms_coefficient() * kappa_t * kappa_t
            endcap_t = jnp.abs(node_xyzr[:, 2:3]) >= cfg.endcap_boundary
            vms_t = jnp.where(endcap_t,
                              vms_t * jnp.abs(dr_t) / jnp.abs(dz_t), vms_t)
            slot_ms = jnp.where(proc_slot, vms_t, 0.0)
        # inclusive-cumsum-at-slot as ONE triangular-masked row-gather
        # reduce: cum_e = sum_{k <= slot_out} slot_ms[src, k].  Same
        # one-hot multiply-reduce lowering as gtools.table_lookup (the
        # (E, K) intermediate fuses into the gather consumer), with the
        # (N, K) cumsum materialization folded into the mask.
        rows_e = slot_ms[g.src]                    # (E, K)
        tri = (jnp.arange(slot_ms.shape[1], dtype=g.slot_out.dtype)[None, :]
               <= g.slot_out[:, None])
        cum_e = jnp.sum(jnp.where(tri, rows_e, 0.0), axis=1)
        total_ms = jnp.sum(slot_ms, axis=1)
        new_merged_cov = g.merged_cov.at[:, 1, 1].add(
            jnp.where(g.has_merged, total_ms, 0.0))
    else:
        cum_e = var_ms
        new_merged_cov = g.merged_cov

    cov_eff = merged_cov_src.at[:, 1, 1].add(cum_e)

    # --- frame change + transport (ref :40-79) ---
    # cos/sin(arctan2(y, x)) == (x, y)/hypot(x, y): two arctan2 + sin + cos
    # transcendentals (the reference's literal formulation) become two
    # rsqrts — same values to ~1 ulp.  Denominators are clamped to tiny so
    # blank/padded rows (nx=ny=0 or cross=dot=0) stay finite like the
    # arctan2 formulation (arctan2(0,0)=0) instead of carrying NaN.
    inv_rho_n = jax.lax.rsqrt(
        jnp.maximum(nx_ * nx_ + ny_ * ny_, linalg.tiny(dtype)))
    ca, sa = nx_ * inv_rho_n, ny_ * inv_rho_n
    x_A = (mx_ - nx_) * ca + (my_ - ny_) * sa
    cross = nx_ * my_ - ny_ * mx_
    dot = nx_ * mx_ + ny_ * my_
    inv_h = jax.lax.rsqrt(
        jnp.maximum(cross * cross + dot * dot, linalg.tiny(dtype)))
    sp, cp = cross * inv_h, dot * inv_h

    F = _jacobian_and_transport(a, b, c, x_A, sp, cp)
    extrp = linalg.mat3_vec(F, merged)
    extrp_cov = linalg.sandwich3(F, cov_eff)

    # --- chi2 gate (ref :132-140,297-298) ---
    S = extrp_cov[:, 2, 2] + cfg.sigma0xy ** 2
    chi2 = extrp[:, 2] * extrp[:, 2] / S
    passed = proc & (chi2 <= cfg.chi2_cut_factor)
    failed = proc & ~passed

    # --- Kalman predict (double transport, ref :306-322) + Joseph update ---
    two_pi = 2.0 * jnp.pi
    likelihood = jax.lax.rsqrt(two_pi * jnp.abs(S)) * jnp.exp(-0.5 * chi2)

    Q = jnp.zeros_like(extrp_cov).at[:, 1, 1].set(var_ms)
    if cfg.bug_compat:
        x_pred = linalg.mat3_vec(F, extrp)
        P_pred = linalg.sandwich3(F, extrp_cov) + Q
    else:
        x_pred = extrp
        P_pred = extrp_cov + Q
    R = jnp.asarray(cfg.sigma0xy ** 2, dtype)
    Sk = P_pred[:, 2, 2] + R
    K = P_pred[:, :, 2] / Sk[:, None]          # gain for H = [0, 0, 1]
    x_post = x_pred + K * (0.0 - x_pred[:, 2])[:, None]
    ikh = jnp.eye(3, dtype=dtype) - K[:, :, None] * jnp.array(
        [0.0, 0.0, 1.0], dtype)[None, None, :]
    P_post = linalg.sandwich3(ikh, P_pred) + R * K[:, :, None] * K[:, None, :]

    # --- joint [a, b, tau] rebuild (ref :325-365) ---
    tau = dz / dr
    sz1, sr1 = rz_sigmas(nz_, cfg, dtype)
    sz2, sr2 = rz_sigmas(mz_, cfg, dtype)
    inv_dr = 1.0 / dr
    var_tau = (inv_dr * inv_dr * (sz1 * sz1 + sz2 * sz2)
               + (dz * inv_dr * inv_dr) ** 2 * (sr1 * sr1 + sr2 * sr2))
    joint = jnp.stack([x_post[:, 0], x_post[:, 1], tau], axis=-1)
    joint_cov = P_post.at[:, :, 2].set(0.0).at[:, 2, :].set(0.0)
    joint_cov = joint_cov.at[:, 2, 2].set(var_tau + var_ms)
    if cfg.bug_compat:
        P_post = joint_cov                     # alias (ref :362-365)

    # --- write updated states on passing edges (ref :441-447) ---
    # reverse-edge weight (ref :384).  The build interleaves each edge with
    # its reverse (reverse == e XOR 1), so this is a pair swap, not a gather.
    w = g.seed_weight.reshape(-1, 2)[:, ::-1].reshape(-1)
    sel = passed
    sv_ = lambda new, old: jnp.where(sel[:, None], new, old)
    sm_ = lambda new, old: jnp.where(sel[:, None, None], new, old)
    out = g.replace(
        merged_cov=new_merged_cov,
        active=g.active & ~failed,
        has_updated=g.has_updated | sel,
        upd_sv=sv_(x_post, g.upd_sv),
        upd_cov=sm_(P_post, g.upd_cov),
        upd_joint=sv_(joint, g.upd_joint),
        upd_joint_cov=sm_(joint_cov, g.upd_joint_cov),
        upd_weight=jnp.where(sel, w, g.upd_weight),
        upd_likelihood=jnp.where(sel, likelihood, g.upd_likelihood),
        # snapshot of the tail's GNN coords, the reference's in-dict
        # 'xyzr' record (ref :374-377) read back by clustering and the
        # side norms — immune to later coordinate mutations
        upd_xyzr=jnp.where(sel[:, None], tail_xyzr, g.upd_xyzr),
    )
    if return_debug:
        return out, (chi2, proc)
    return out
