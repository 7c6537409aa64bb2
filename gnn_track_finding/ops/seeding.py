"""Edge-parallel track-state seeding.

Re-derivation of the reference's per-node/per-neighbour Python loop
``compute_track_state_estimates`` (helper.py:238-452) as one vectorised
kernel over the directed-edge axis.  For edge e = (src -> dst), dst is the
"node" owning the state and src the "neighbour":

  1. rotate/translate into dst's local frame (origin at dst, x-axis through
     the beamline origin; helper.py:354-366),
  2. solve the parabola y = a x^2/2-free form through (origin, dst, src) via
     a closed-form 3x3 inverse H^-1 (helper.py:378-389),
  3. covariance H^-1 S H^-T with S = diag(sigma_O^2, sigma_A^2, sigma_B^2)
     (helper.py:248-250,417),
  4. Highland/Moliere multiple-scattering variance added to the direction
     parameter b (helper.py:391-418),
  5. joint state [a, b, tau] with tau = dz/dr and its covariance from a
     4-point Jacobian over the two hits' (z, r) errors with barrel/endcap
     sigma swaps (helper.py:296-331,419-425).

bug_compat reproduces two load-bearing quirks of the reference:
  * helper.py:421 squares the tau variance (``del_tau**2``),
  * helper.py:422-425 aliases ``joint_vector_covariance = covariance`` so
    the stored parabolic covariance is ALSO zeroed in its third row/column
    with [2,2] = var_tau + var_ms.  The downstream xy chi2 gate
    (extrapolate_merged_states.py:134-140) reads that [2,2] element, so
    this aliasing is part of the reference's effective algorithm.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from gnn_track_finding.config import PipelineConfig
from gnn_track_finding.graph.state import GraphState
from gnn_track_finding.ops import linalg


def rz_sigmas(z, cfg: PipelineConfig, dtype):
    """(sigma_z, sigma_r) for hits at coordinate z.

    Barrel default sigma_r = sigma0rz, sigma_z = sigma0rz2; swapped in the
    endcap where layers are vertical (helper.py:272-277,308-314).
    """
    endcap = jnp.abs(z) >= cfg.endcap_boundary
    s_rz = jnp.asarray(cfg.sigma0rz, dtype)
    s_rz2 = jnp.asarray(cfg.sigma0rz2, dtype)
    sigma_z = jnp.where(endcap, s_rz, s_rz2)
    sigma_r = jnp.where(endcap, s_rz2, s_rz)
    return sigma_z, sigma_r


def tau_variance(node_zr, nb_zr, cfg: PipelineConfig):
    """Variance of tau = dz/dr from the two hits' z/r measurement errors.

    J = [d tau/d z1, d tau/d z2, d tau/d r1, d tau/d r2] against
    S2 = diag(sigma_z1^2, sigma_z2^2, sigma_r1^2, sigma_r2^2)
    (helper.py:316-331); subscript 1 = node (dst), 2 = neighbour (src).
    """
    z1, r1 = node_zr
    z2, r2 = nb_zr
    dtype = z1.dtype
    inv_dr = 1.0 / (r1 - r2)
    j1 = inv_dr
    j2 = -inv_dr
    j3 = -(z1 - z2) * inv_dr * inv_dr
    j4 = (z1 - z2) * inv_dr * inv_dr
    sz1, sr1 = rz_sigmas(z1, cfg, dtype)
    sz2, sr2 = rz_sigmas(z2, cfg, dtype)
    return (j1 * j1 * sz1 * sz1 + j2 * j2 * sz2 * sz2
            + j3 * j3 * sr1 * sr1 + j4 * j4 * sr2 * sr2)


def highland_var_ms(a, b, kappa_x, node_zr, nb_zr, cfg: PipelineConfig):
    """Highland-formula multiple-scattering variance (helper.py:400-415).

    kappa = 2a / (1 + (2a*kappa_x + b)^2)^(3/2) with kappa_x the GLOBAL x of
    the reference point (the neighbour's x in seeding, helper.py:394,408).
    sin(theta) from the segment's (dr, dz); extra |dr/dz| factor when the
    owning node sits in the endcap (helper.py:412-415).
    """
    node_z, node_r = node_zr
    nb_z, nb_r = nb_zr
    dr = node_r - nb_r
    dz = node_z - nb_z
    hyp = jnp.sqrt(dr * dr + dz * dz)
    sin_t = jnp.abs(dr) / hyp
    kappa = (2.0 * a) / (1.0 + (2.0 * a * kappa_x + b) ** 2) ** 1.5
    var_ms = sin_t * cfg.ms_coefficient() * kappa * kappa
    endcap = jnp.abs(node_z) >= cfg.endcap_boundary
    return jnp.where(endcap, var_ms * jnp.abs(dr / dz), var_ms)


def seed_track_states(g: GraphState, cfg: PipelineConfig,
                      axis_name=None) -> GraphState:
    """Compute per-edge seed states for every directed edge, plus the
    per-node edge-gradient statistics (helper.py:446-447)."""
    dtype = g.dtype
    # static pre-gathered endpoint coordinates (no dynamic gathers)
    sx, sy, sz, sr = (g.e_xyzr[:, i] for i in range(4))       # neighbour (tail)
    dx_, dy_, dz_, dr_ = (g.e_xyzr[:, 4 + i] for i in range(4))  # node (head)

    # --- local frame of the head node (helper.py:354-366) ---
    azimuth = jnp.arctan2(dy_, dx_)
    ca, sa = jnp.cos(azimuth), jnp.sin(azimuth)
    # origin transformed: (0,0) -> (x_0, .)
    x_0 = (0.0 - dx_) * ca + (0.0 - dy_) * sa
    # neighbour transformed -> (x_B, m_B)
    x_B = (sx - dx_) * ca + (sy - dy_) * sa
    m_B = -(sx - dx_) * sa + (sy - dy_) * ca

    # --- parabola solve through (origin, node, neighbour) (helper.py:375-389)
    ones = jnp.ones_like(x_0)
    zeros = jnp.zeros_like(x_0)
    H = jnp.stack([
        jnp.stack([0.5 * x_0 * x_0, x_0, ones], axis=-1),
        jnp.stack([zeros, zeros, ones], axis=-1),
        jnp.stack([0.5 * x_B * x_B, x_B, ones], axis=-1),
    ], axis=-2)
    H_inv = linalg.inv3(H)
    # measurement vector is [0, 0, m_B] (m_O = m_A = 0, helper.py:252-253)
    sv = H_inv[..., 2] * m_B[..., None]
    a, b = sv[..., 0], sv[..., 1]

    S = jnp.zeros_like(H)
    S = S.at[..., 0, 0].set(cfg.sigma_O ** 2)
    S = S.at[..., 1, 1].set(cfg.sigma0xy ** 2)
    S = S.at[..., 2, 2].set(cfg.sigma0xy ** 2)
    cov = linalg.sandwich3(H_inv, S)

    # --- multiple scattering on the direction parameter (helper.py:391-418)
    var_ms = highland_var_ms(a, b, sx, (dz_, dr_), (sz, sr), cfg)
    cov = cov.at[..., 1, 1].add(var_ms)

    # --- joint [a, b, tau] state (helper.py:419-425) ---
    tau = (sz - dz_) / (sr - dr_)
    var_tau = tau_variance((dz_, dr_), (sz, sr), cfg)
    if cfg.bug_compat:
        # tau-pairing defect (helper.py:349-429): the reversed coords/keys
        # loop indexes the tau/variance lists with the un-reversed order,
        # so each edge carries the MIRROR neighbour's tau and tau variance
        # (mirror computed at build in the reference's set() order);
        # var_ms stays the edge's own (helper.py:425).
        # Donor values are RECOMPUTED from the mirror edge's tail
        # coordinates (static mirror_src ids into the replicated node
        # coords) rather than gathered from the mirror edge's slot: the
        # mirror can point at any in-edge of the same head node, so a
        # value gather would cross shards under the edge partition.
        # Bitwise identical: e_xyzr tail == xyzr[src] by construction
        # (build.py), and the donor shares this edge's head coords.
        # FULL-ROW gather then slice (one (1, 4)-row gather, not two
        # narrowed column gathers).
        mrows = g.xyzr[g.mirror_src]
        msz = mrows[:, 2]
        msr = mrows[:, 3]
        tau = (msz - dz_) / (msr - dr_)
        var_tau = tau_variance((dz_, dr_), (msz, msr), cfg)
        var_tau_eff = var_tau * var_tau + var_ms  # helper.py:421 squares it
    else:
        var_tau_eff = var_tau + var_ms
    joint = jnp.stack([a, b, tau], axis=-1)
    joint_cov = cov.at[..., :, 2].set(0.0).at[..., 2, :].set(0.0)
    joint_cov = joint_cov.at[..., 2, 2].set(var_tau_eff)
    if cfg.bug_compat:
        # helper.py:422-425: edge_covariance aliases joint_vector_covariance
        cov = joint_cov

    # --- per-node gradient statistics over in-edges (helper.py:287-303,446-447)
    from gnn_track_finding.ops import collect
    n = g.num_padded_nodes
    w = g.edge_mask.astype(dtype)
    grad_xy = (sy - dy_) / (sx - dx_)
    cnt = collect.allsum(jax.ops.segment_sum(w, g.dst, n), axis_name)
    safe = jnp.maximum(cnt, 1.0)

    def mean_var(vals):
        s1 = collect.allsum(jax.ops.segment_sum(w * vals, g.dst, n),
                            axis_name)
        s2 = collect.allsum(jax.ops.segment_sum(w * vals * vals, g.dst, n),
                            axis_name)
        mean = s1 / safe
        var = s2 / safe - mean * mean
        return mean, jnp.maximum(var, 0.0)

    mx, vx = mean_var(jnp.where(g.edge_mask, grad_xy, 0.0))
    mz, vz = mean_var(jnp.where(g.edge_mask, tau, 0.0))
    grad_stats = jnp.stack([mx, vx, mz, vz], axis=-1)

    em = g.edge_mask
    emv = em[:, None]
    emm = em[:, None, None]
    return g.replace(
        seed_sv=jnp.where(emv, sv, 0.0),
        seed_cov=jnp.where(emm, cov, 0.0),
        seed_joint=jnp.where(emv, joint, 0.0),
        seed_joint_cov=jnp.where(emm, joint_cov, 0.0),
        grad_stats=grad_stats,
    )
