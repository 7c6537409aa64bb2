"""NumPy oracle of the reference pipeline's semantics.

A from-scratch, line-cited re-statement of the algorithms in the
reference repository (NOT a copy): it operates on NetworkX graphs with the
reference's attribute schema and reproduces its numerics — including the
load-bearing quirks flagged in SURVEY.md — so the device kernels can be tested
against it, and it in turn can be tested against the actual reference
modules where those are importable (helper/clustering are pure numpy).

Reproduced quirks (each cited at its use site):
  * covariance aliasing: stored parabolic covariance == joint covariance
    (helper.py:422-425, extrapolate_merged_states.py:362-365)
  * squared tau variance (helper.py:421)
  * cumulative in-place var_ms on a node's merged_cov across its neighbour
    loop (extrapolate_merged_states.py:127-128)
  * KalmanFilter.predict applied on top of an already-extrapolated state
    (extrapolate_merged_states.py:307-322 — F is applied twice)
  * elementwise-product trace in the KL distance (clustering.py:93)
  * db'/db uses ds_da (extrapolate_merged_states.py:98)
  * mixture weight of the updated state read from the REVERSE edge's seed
    state (extrapolate_merged_states.py:384)
  * r/z rotation uses r twice / z twice (extract_track_candidates.py:190-191)
  * scalar Q broadcast-added to every covariance entry in the zr fit
    (extract_track_candidates.py:302 with filterpy semantics)

Intended-semantics deviations (documented in ops/priors.py): the stale-
variable side-norm assignment (helper.py:129-139) is replaced by per-edge
assignment, and confusion counters accumulate.
"""

from __future__ import annotations

import math

import numpy as np
from scipy.stats import distributions


# --------------------------------------------------------------------------
# small-matrix helpers
# --------------------------------------------------------------------------

def merge_states(mean1, cov1, mean2, cov2):
    """Inverse-variance weighted merge (clustering.py:97-105)."""
    i1 = np.linalg.inv(cov1)
    i2 = np.linalg.inv(cov2)
    merged_cov = np.linalg.inv(i1 + i2)
    merged_mean = merged_cov @ (i1 @ mean1 + i2 @ mean2)
    return merged_mean, merged_cov


def kl_distance(mean1, cov1, mean2, cov2):
    """clustering.py:90-94 — note elementwise product inside the trace."""
    i1 = np.linalg.inv(cov1)
    i2 = np.linalg.inv(cov2)
    trace = np.trace((cov1 - cov2) * (i2 - i1))
    d = mean1 - mean2
    return trace + d @ (i1 + i2) @ d


def rz_sigmas(z, cfg):
    if abs(z) >= cfg.endcap_boundary:
        return cfg.sigma0rz, cfg.sigma0rz2   # (sigma_z, sigma_r) endcap
    return cfg.sigma0rz2, cfg.sigma0rz


# --------------------------------------------------------------------------
# seeding (helper.py:238-452)
# --------------------------------------------------------------------------

def seed_states(G, cfg, neighbour_order=None):
    """Attach 'track_state_estimates' and gradient stats to every node.

    Mirrored tau pairing (helper.py:349-429): the reference reverses
    coords/keys between its two loops but indexes the tau/theta lists with
    the un-reversed variable, so neighbour k (in set() iteration order)
    receives the tau and tau-variance of neighbour d-1-k.
    """
    S = np.diag([cfg.sigma_O ** 2, cfg.sigma0xy ** 2, cfg.sigma0xy ** 2])
    for node in G.nodes():
        nx_, ny_, nz_, nr_ = G.nodes[node]["xyzr"]
        if neighbour_order is not None:
            nbs = neighbour_order(G, node)
        else:
            nbs = sorted(set(list(G.predecessors(node)) + list(G.successors(node))))
        # mirror map in the reference's genuine set() iteration order
        set_order = list(set(list(G.predecessors(node))
                             + list(G.successors(node))))
        d_ = len(set_order)
        mirror_of = {set_order[k]: set_order[d_ - 1 - k] for k in range(d_)}

        def tau_and_var(nb):
            bx, by, bz, br = G.nodes[nb]["xyzr"]
            t = (bz - nz_) / (br - nr_)
            sz1, sr1 = rz_sigmas(nz_, cfg)
            sz2, sr2 = rz_sigmas(bz, cfg)
            inv_dr = 1.0 / (nr_ - br)
            jv = np.array([inv_dr, -inv_dr,
                           -(nz_ - bz) * inv_dr ** 2, (nz_ - bz) * inv_dr ** 2])
            s2 = np.diag([sz1 ** 2, sz2 ** 2, sr1 ** 2, sr2 ** 2])
            return t, jv @ s2 @ jv
        azimuth = math.atan2(ny_, nx_)
        ca, sa = np.cos(azimuth), np.sin(azimuth)
        x_0 = (0.0 - nx_) * ca + (0.0 - ny_) * sa
        grads_xy, grads_zr = [], []
        estimates = {}
        for nb in nbs:
            bx, by, bz, br = G.nodes[nb]["xyzr"]
            grads_xy.append((by - ny_) / (bx - nx_))
            tau = (bz - nz_) / (br - nr_)
            grads_zr.append(tau)

            x_B = (bx - nx_) * ca + (by - ny_) * sa
            m_B = -(bx - nx_) * sa + (by - ny_) * ca
            H = np.array([[0.5 * x_0 ** 2, x_0, 1.0],
                          [0.0, 0.0, 1.0],
                          [0.5 * x_B ** 2, x_B, 1.0]])
            H_inv = np.linalg.inv(H)
            sv = H_inv @ np.array([0.0, 0.0, m_B])
            a, b = sv[0], sv[1]
            cov = H_inv @ S @ H_inv.T

            # multiple scattering (helper.py:391-418); x_k is GLOBAL nb x
            dr = nr_ - br
            dz = nz_ - bz
            sin_t = abs(dr) / math.hypot(dr, dz)
            kappa = (2 * a) / (1 + (2 * a * bx + b) ** 2) ** 1.5
            var_ms = sin_t * ((13.6e-3 * math.sqrt(0.02) * kappa) / 0.3) ** 2
            if abs(nz_) >= cfg.endcap_boundary:
                var_ms *= abs(dr / dz)
            cov[1, 1] += var_ms

            # mirrored tau pairing (helper.py:419-421): tau and its variance
            # come from the mirror neighbour; var_ms stays this edge's own
            tau_m, var_tau = tau_and_var(mirror_of[nb])

            joint = np.array([a, b, tau_m])
            # helper.py:421-425: squared var_tau, aliased covariance
            joint_cov = cov              # ALIAS — mutations hit cov too
            joint_cov[:, 2] = 0.0
            joint_cov[2, :] = 0.0
            joint_cov[2, 2] = var_tau ** 2 + var_ms

            estimates[nb] = {
                "xyzr": (bx, by, bz, br),
                "edge_state_vector": sv,
                "edge_covariance": cov,
                "joint_vector": joint,
                "joint_vector_covariance": joint_cov,
            }
        G.nodes[node]["track_state_estimates"] = estimates
        G.nodes[node]["xy_edge_gradient_mean_var"] = (
            np.mean(grads_xy) if grads_xy else 0.0,
            np.var(grads_xy) if grads_xy else 0.0)
        G.nodes[node]["zr_edge_gradient_mean_var"] = (
            np.mean(grads_zr) if grads_zr else 0.0,
            np.var(grads_zr) if grads_zr else 0.0)
    return G


# --------------------------------------------------------------------------
# activation / weights / priors / degree (helper.py:24-96,67-73)
# --------------------------------------------------------------------------

def initialize_edge_activation(G):
    for u, v in G.edges():
        G[u][v]["activated"] = 1


def compute_mixture_weights(G, key):
    for node, attr in G.nodes(data=True):
        if key not in attr:
            continue
        states = attr[key]
        if not states:
            continue
        w = 1.0 / len(states)
        for v in states.values():
            v["mixture_weight"] = w


def compute_prior_probabilities(G, key):
    edges = set(G.edges())
    for node, attr in G.nodes(data=True):
        if key not in attr:
            continue
        states = attr[key]
        by_layer = {}
        for nb in states:
            if (nb, node) in edges and G[nb][node]["activated"] == 1:
                by_layer.setdefault(G.nodes[nb]["in_volume_layer_id"], []).append(nb)
        for nbs in by_layer.values():
            p = 1.0 / len(nbs)
            for nb in nbs:
                states[nb]["prior"] = p


def query_degree(G, node):
    return sum(1 for nb, _ in G.in_edges(node)
               if G[nb][node]["activated"] == 1)


def update_degrees(G):
    for node in G.nodes():
        G.nodes[node]["degree"] = query_degree(G, node)


def reweight(G, key, cfg):
    """helper.py:143-201 with intended side-norm semantics (see module doc)."""
    edges = set(G.edges())
    for node, attr in G.nodes(data=True):
        if key not in attr:
            continue
        states = attr[key]
        node_x = G.nodes[node]["xyzr"][0]

        def is_active(nb):
            return (nb, node) in edges and G[nb][node]["activated"] == 1

        left = {nb for nb in states if is_active(nb)
                and states[nb]["xyzr"][0] < node_x}
        right = {nb for nb in states if is_active(nb) and nb not in left}
        left_norm = len({states[nb]["xyzr"][0] for nb in left})
        right_norm = len({states[nb]["xyzr"][0] for nb in right})

        denom = sum(states[nb]["mixture_weight"] * states[nb]["likelihood"]
                    for nb in states if is_active(nb))
        if denom == 0.0:
            continue
        for nb, sd in states.items():
            if not is_active(nb):
                continue
            norm = left_norm if nb in left else right_norm
            w = sd["mixture_weight"] * sd["likelihood"] * sd["prior"] / denom
            w /= max(norm, 1)
            sd["mixture_weight"] = w
            G[nb][node]["activated"] = 0 if w < cfg.reweight_threshold else 1


# --------------------------------------------------------------------------
# clustering / GMR (clustering.py:11-316)
# --------------------------------------------------------------------------

def pairwise_chi2(node_coords, nb_coords, joints, joint_covs, cfg):
    """clustering.py:11-86.  NOTE the endcap test uses the X coordinate
    (clustering.py:49-57 reads node_coords[0]) — reproduced as-is."""
    k = len(joints)
    out = np.zeros((k, k))
    x_a, _, z_a, r_a = node_coords

    def sig(xcoord):
        if abs(xcoord) >= cfg.endcap_boundary:
            return cfg.sigma0rz, cfg.sigma0rz2   # (sigma_z, sigma_r)
        return cfg.sigma0rz2, cfg.sigma0rz

    sza, sra = sig(x_a)
    for i in range(k):
        for j in range(i):
            ri = joints[i][:2] - joints[j][:2]
            c = joint_covs[i][:2, :2] + joint_covs[j][:2, :2]
            d1 = ri @ np.linalg.inv(c) @ ri
            x_b, _, z_b, r_b = nb_coords[i]
            x_c, _, z_c, r_c = nb_coords[j]
            j2 = 1.0 / (r_b - r_a)
            j3 = -1.0 / (r_c - r_a)
            j1 = -j3 - j2
            j5 = -(z_b - z_a) / (r_b - r_a) ** 2
            j6 = (z_c - z_a) / (r_c - r_a) ** 2
            j4 = -j5 - j6
            szb, srb = sig(x_b)
            szc, src_ = sig(x_c)
            jac = np.array([j1, j2, j3, j4, j5, j6])
            s = np.diag([sza ** 2, szb ** 2, szc ** 2,
                         sra ** 2, srb ** 2, src_ ** 2])
            cov_dt = jac @ s @ jac
            tau1 = (z_b - z_a) / (r_b - r_a)
            tau2 = (z_c - z_a) / (r_c - r_a)
            d2 = (tau1 - tau2) ** 2 / cov_dt
            out[i, j] = d1 + d2
    return out


def cluster(G, key, chi2_threshold, kl_threshold, cfg,
            min_edges=3, max_edges=15):
    """clustering.py:149-316 on one graph; returns deactivated edge list."""
    edges_to_deactivate = []
    for node, attr in G.nodes(data=True):
        if key not in attr:
            continue
        states = attr[key]
        num = len(states)
        if num < min_edges or num > max_edges:
            continue
        nbs = list(states.keys())
        p_svs = [np.array(states[n]["edge_state_vector"], float) for n in nbs]
        p_covs = [np.array(states[n]["edge_covariance"], float) for n in nbs]
        j_svs = [np.array(states[n]["joint_vector"], float) for n in nbs]
        j_covs = [np.array(states[n]["joint_vector_covariance"], float) for n in nbs]
        priors = [states[n]["prior"] for n in nbs]
        nb_coords = [states[n]["xyzr"] for n in nbs]
        node_coords = attr["xyzr"]

        dists = pairwise_chi2(node_coords, nb_coords, j_svs, j_covs, cfg)
        nz = dists[np.nonzero(dists)]
        if nz.size == 0:
            continue
        smallest = nz.min()
        if smallest >= chi2_threshold:
            continue
        row, col = np.where(dists == smallest)
        i0, i1 = int(row[0]), int(col[0])

        pm, pc = merge_states(p_svs[i0], p_covs[i0], p_svs[i1], p_covs[i1])
        jm, jc = merge_states(j_svs[i0], j_covs[i0], j_svs[i1], j_covs[i1])
        merged_prior = priors[i0] + priors[i1]

        remaining = [i for i in range(num) if i not in (i0, i1)]
        while remaining:
            dl = [kl_distance(j_svs[i], j_covs[i], jm, jc) for i in remaining]
            k_best = int(np.argmin(dl))
            if dl[k_best] >= kl_threshold:
                break
            i_abs = remaining[k_best]
            pm, pc = merge_states(p_svs[i_abs], p_covs[i_abs], pm, pc)
            jm, jc = merge_states(j_svs[i_abs], j_covs[i_abs], jm, jc)
            merged_prior += priors[i_abs]
            remaining.remove(i_abs)

        G.nodes[node]["merged_state"] = pm
        G.nodes[node]["merged_cov"] = pc
        G.nodes[node]["merged_prior"] = merged_prior
        for i in remaining:
            edges_to_deactivate.append((nbs[i], node))

    # simultaneous deactivation (clustering.py:309-316)
    for nb, node in edges_to_deactivate:
        G[nb][node]["activated"] = 0
    return edges_to_deactivate


# --------------------------------------------------------------------------
# extrapolation / message passing (extrapolate_merged_states.py:26-518)
# --------------------------------------------------------------------------

def _kf_update_joseph(x, P, H, R, z):
    """filterpy KalmanFilter.update semantics (Joseph-form covariance)."""
    y = z - H @ x
    S = H @ P @ H.T + R
    K = P @ H.T @ np.linalg.inv(S)
    x_post = x + K @ y
    ikh = np.eye(len(x)) - K @ H
    P_post = ikh @ P @ ikh.T + K @ np.array([[R]]) @ K.T
    return x_post, P_post


def extrapolate_validate(G, node, nb, state, state_cov, cfg):
    """extrapolate_merged_states.py:26-402 for one (node -> nb) edge.

    state_cov is MUTATED in place (var_ms added to [1,1]) exactly like the
    reference mutates the stored merged_cov at lines 127-128.
    Returns (updated_dict_or_None, chi2).
    """
    nx_, ny_, nz_, nr_ = G.nodes[node]["xyzr"]
    bx, by, bz, br = G.nodes[nb]["xyzr"]

    alpha = math.atan2(ny_, nx_)
    x_A = (bx - nx_) * np.cos(alpha) + (by - ny_) * np.sin(alpha)
    y_A = -(bx - nx_) * np.sin(alpha) + (by - ny_) * np.cos(alpha)
    a, b, c = state[0], state[1], state[2]
    phi = math.atan2(nx_ * by - ny_ * bx, nx_ * bx + ny_ * by)
    sp, cp = np.sin(phi), np.cos(phi)

    x_p = x_A + c * sp
    vx = cp + b * sp
    ax = a * sp
    s_star = (-x_p * (2 * vx ** 2 + ax * x_p)) / (2 * vx ** 3)
    vy = -sp + b * cp
    ay = a * cp

    numer = x_A + c * sp
    den1 = cp + b * sp
    ds_da = -(sp * numer ** 2) / den1 ** 3
    ds_db = (sp * numer * (1 + (3 * a * sp * numer) / den1 ** 2)) / den1 ** 2
    ds_dc = -sp * (1 + (2 * a * sp * numer) / den1 ** 2) / den1

    den2 = cp + (2 * a + b) * sp
    da_da = (1 / den2 ** 3) * (1 - (6 * a * sp) * (s_star + a * ds_da) / den2)
    da_db = (-3 * a * sp * (2 * a * ds_db + 1)) / den2 ** 4
    da_dc = (-6 * sp * ds_dc * a ** 2) / den2 ** 4

    den3 = cp + (2 * a * s_star + b) * sp
    br3 = cp - (sp * (-sp + (2 * a * s_star + b) * cp)) / den3
    db_da = 2 * (s_star + a * ds_da) * br3 / den3
    db_db = (1 + 2 * a * ds_da) * br3 / den3   # ds_da: ref line 98 quirk
    db_dc = 2 * a * ds_dc * br3 / den3

    br4 = cp * (2 * a + b) - sp
    dc_da = ds_da * br4 + s_star ** 2 * cp
    dc_db = ds_db * br4 + s_star * cp
    dc_dc = ds_dc * br4 + cp

    F = np.array([[da_da, da_db, da_dc],
                  [db_da, db_db, db_dc],
                  [dc_da, dc_db, dc_dc]])

    dr = br - nr_
    dz = bz - nz_
    sin_t = abs(dr) / math.hypot(dr, dz)
    kappa = (2 * a) / (1 + (2 * a * bx + b) ** 2) ** 1.5
    var_ms = sin_t * ((13.6e-3 * math.sqrt(0.02) * kappa) / 0.3) ** 2
    if abs(nz_) >= cfg.endcap_boundary:
        var_ms *= abs(dr) / abs(dz)

    state_cov[1, 1] += var_ms          # in-place, cumulative (ref :127-128)
    extrp = F @ state
    extrp_cov = F @ state_cov @ F.T

    S = extrp_cov[2, 2] + cfg.sigma0xy ** 2
    residual = 0.0 - extrp[2]
    chi2 = residual * residual / S

    if chi2 > cfg.chi2_cut_factor:
        G[node][nb]["activated"] = 0
        return None, chi2

    likelihood = (2 * math.pi * abs(S)) ** -0.5 * math.exp(-0.5 * chi2)

    # filterpy-style predict on the already-extrapolated state (ref :306-322)
    Q = np.diag([0.0, var_ms, 0.0])
    x_pred = F @ extrp
    P_pred = F @ extrp_cov @ F.T + Q
    H = np.array([[0.0, 0.0, 1.0]])
    x_post, P_post = _kf_update_joseph(x_pred, P_pred, H, cfg.sigma0xy ** 2, np.array([0.0]))

    tau = dz / dr
    sz1, sr1 = rz_sigmas(nz_, cfg)
    sz2, sr2 = rz_sigmas(bz, cfg)
    j = np.array([1 / dr, -1 / dr, -dz / dr ** 2, dz / dr ** 2])
    s2 = np.diag([sz1 ** 2, sz2 ** 2, sr1 ** 2, sr2 ** 2])
    var_tau = j @ s2 @ j

    joint = np.array([x_post[0], x_post[1], tau])
    joint_cov = P_post                 # alias (ref :362-365)
    joint_cov[:, 2] = 0.0
    joint_cov[2, :] = 0.0
    joint_cov[2, 2] = var_tau + var_ms

    return {
        "xyzr": (nx_, ny_, nz_, nr_),   # SENDER coords (ref :375-377)
        "edge_state_vector": x_post,
        "edge_covariance": P_post,
        "joint_vector": joint,
        "joint_vector_covariance": joint_cov,
        "likelihood": likelihood,
        # reverse-edge seed weight (ref :384)
        "mixture_weight": G.nodes[node]["track_state_estimates"][nb]["mixture_weight"],
    }, chi2


def message_passing(G, cfg, neighbour_order=None):
    """extrapolate_merged_states.py:406-518 on one graph."""
    for node, attr in list(G.nodes(data=True)):
        if "merged_state" not in attr:
            continue
        state = attr["merged_state"]
        cov = attr["merged_cov"]       # mutated across the neighbour loop
        nbs = (neighbour_order(G, node) if neighbour_order
               else list(G.successors(node)))
        for nb in nbs:
            if G[node][nb]["activated"] != 1:
                continue
            upd, _ = extrapolate_validate(G, node, nb, state, cov, cfg)
            if upd is not None:
                G.nodes[nb].setdefault("updated_track_states", {})[node] = upd


def extrapolation_stage(G, cfg, neighbour_order=None):
    """Full even-iteration stage (extrapolate_merged_states.py:550-567)."""
    message_passing(G, cfg, neighbour_order)
    compute_prior_probabilities(G, "updated_track_states")
    reweight(G, "updated_track_states", cfg)
    compute_prior_probabilities(G, "updated_track_states")
    reweight(G, "updated_track_states", cfg)
    update_degrees(G)


# --------------------------------------------------------------------------
# metadata pruning (remove_state_metadata.py:31-53)
# --------------------------------------------------------------------------

def remove_state_metadata(G, cfg):
    for node, attr in G.nodes(data=True):
        key = ("updated_track_states" if "updated_track_states" in attr
               else "track_state_estimates")
        states = attr.get(key)
        if states is None:
            continue
        nbs = set(G.successors(node)) | set(G.predecessors(node))
        for sn in list(states.keys()):
            if sn not in nbs:
                del states[sn]
    compute_prior_probabilities(G, "track_state_estimates")
    compute_prior_probabilities(G, "updated_track_states")
    reweight(G, "updated_track_states", cfg)


# --------------------------------------------------------------------------
# extraction (extract_track_candidates.py:42-346)
# --------------------------------------------------------------------------

def rotate_track(coords, separation_3d_threshold):
    """extract_track_candidates.py:155-193 including the r/z typo."""
    p1 = coords[-1]
    p2 = coords[-2]
    d = math.dist(p1[:3], p2[:3])
    if d < separation_3d_threshold:
        p2 = coords[-3]
    angle_xy = math.atan2(p2[1] - p1[1], p2[0] - p1[0])
    angle_zr = math.atan2(p2[2] - p1[2], p2[3] - p1[3])
    out = []
    for x, y, z, r in coords:
        xn = x * np.cos(angle_xy) + y * np.sin(angle_xy)
        yn = -x * np.sin(angle_xy) + y * np.cos(angle_xy)
        rn = r * np.cos(angle_zr) + r * np.sin(angle_zr)   # ref :190 (typo kept)
        zn = -z * np.sin(angle_zr) + z * np.cos(angle_zr)  # ref :191 (typo kept)
        out.append((xn, yn, zn, rn))
    return out


def kf_track_fit(coords, cfg):
    """extract_track_candidates.py:209-328 — OU xy fit + zr fit -> p-values."""
    sxy2 = cfg.sigma0xy ** 2
    srz2 = cfg.sigma0rz ** 2
    x = np.array([coords[0][1], 0.0, 0.0])
    P = np.diag([sxy2, 1.0, 1.0])
    gx = np.array([coords[0][3], 0.0])
    gP = np.array([[srz2, 0.0], [0.0, 1000.0]])
    chi2s, gchi2s = [], []
    H3 = np.array([[1.0, 0.0, 0.0]])
    H2 = np.array([[1.0, 0.0]])
    for i in range(len(coords) - 1):
        x2, y2 = coords[i][0], coords[i][1]
        x3, y3 = coords[i + 1][0], coords[i + 1][1]
        # parabola through origin and the two points
        denom = (0.0 - x2) * (0.0 - x3) * (x2 - x3)
        a = (x3 * (y2 - 0.0) + x2 * (0.0 - y3) + 0.0) / denom
        b = (x3 ** 2 * (0.0 - y2) + x2 ** 2 * (y3 - 0.0) + 0.0) / denom

        z2, r2 = coords[i][2], coords[i][3]
        z3, r3 = coords[i + 1][2], coords[i + 1][3]
        dr, dz = r3 - r2, z3 - z2
        sin_t = abs(dr) / math.hypot(dr, dz)
        kappa = (2 * a) / (1 + (2 * a * x3 + b) ** 2) ** 1.5
        var_ms = sin_t * ((13.6e-3 * math.sqrt(0.02) * kappa) / 0.3) ** 2
        if abs(z3) >= cfg.endcap_boundary:
            var_ms *= abs(dr / dz)

        dx = x3 - x2
        e1 = np.exp(-abs(dx) * cfg.ou_alpha)
        f1 = (1.0 - e1) / cfg.ou_alpha
        g1 = (abs(dx) - f1) / cfg.ou_alpha
        sw2 = cfg.ou_sigma ** 2
        st2 = var_ms
        dx2 = dx * dx
        dxw2 = dx2 * sw2
        q02 = 0.5 * dxw2
        q01 = dx * (st2 + q02)
        q12 = dx * sw2
        F = np.array([[1.0, dx, g1], [0.0, 1.0, f1], [0.0, 0.0, e1]])
        Q = np.array([[dx2 * (st2 + 0.25 * dxw2), q01, q02],
                      [q01, st2 + dxw2, q12],
                      [q02, q12, sw2]])
        x = F @ x
        P = F @ P @ F.T + Q
        x, P = _kf_update_joseph(x, P, H3, sxy2, np.array([y3]))
        res = y3 - (H3 @ x)[0]
        Sk = (H3 @ P @ H3.T)[0, 0] + sxy2
        chi2s.append(res * res / Sk)

        # zr-plane fit: tracks r with scalar Q broadcast (ref :299-316)
        gF = np.array([[1.0, dz], [0.0, 1.0]])
        gx = gF @ gx
        gP = gF @ gP @ gF.T + var_ms       # scalar adds to every entry
        gx, gP = _kf_update_joseph(gx, gP, H2, srz2, np.array([r3]))
        gres = r3 - (H2 @ gx)[0]
        gS = (H2 @ gP @ H2.T)[0, 0] + srz2
        gchi2s.append(gres * gres / gS)

    dof = len(coords) - 2
    pval = distributions.chi2.sf(sum(chi2s), dof)
    pval_zr = distributions.chi2.sf(sum(gchi2s), dof)
    return pval, pval_zr


def cca_active(G):
    """extract_track_candidates.py:332-346: components over active edges."""
    import networkx as nx
    sub = G.copy()
    drop = [(u, v) for u, v in sub.edges() if sub[u][v]["activated"] == 0]
    sub.remove_edges_from(drop)
    return [sub.subgraph(c).copy() for c in nx.weakly_connected_components(sub)]


def check_close_proximity(cand, cfg):
    """extract_track_candidates.py:58-151 -> (coords_by_node or None, n_merged).

    Returns the post-merge coordinate mapping when the candidate can be
    processed (merged where appropriate), else None.  The ORIGINAL node set
    is what gets extracted either way (ref :419-424,444).
    """
    nodes = list(cand.nodes())
    vivl = [cand.nodes[n]["vivl_id"] for n in nodes]
    freq = {v: vivl.count(v) for v in vivl}
    counts = list(freq.values())

    coords = {n: tuple(cand.nodes[n]["xyzr"]) for n in nodes}
    if 2 not in counts:
        merged_coords = None
    else:
        non2 = [c for c in counts if c != 2]
        if (len(counts) - len(non2) <= 2) and all(c == 1 for c in non2):
            merged_coords = dict(coords)
            n_merged = 0
            for dup in {v for v in vivl if vivl.count(v) == 2}:
                pair = [n for n, v in zip(nodes, vivl) if v == dup]
                (x1, y1, z1, _), (x2, y2, z2, _) = (coords[pair[0]], coords[pair[1]])
                d = math.dist((x1, y1, z1), (x2, y2, z2))
                if d <= cfg.node_merge_distance:
                    xm, ym, zm = (x1 + x2) / 2, (y1 + y2) / 2, (z1 + z2) / 2
                    rm = math.hypot(xm, ym)
                    merged_coords[pair[0]] = (xm, ym, zm, rm)
                    del merged_coords[pair[1]]
                    n_merged += 1
                else:
                    merged_coords = None
                    break
        else:
            merged_coords = None

    if merged_coords is not None:
        return merged_coords, True
    return coords, False


def extract_stage(G, cfg, file_of_node):
    """extract_track_candidates.py:349-467 over the whole graph.

    file_of_node maps each node to its original ingest component (the
    reference's per-file granularity for remaining/fragment classification).
    Returns dict with accepted candidate node-sets, p-values, and the node
    sets removed as fragments.  Mutates G by removing extracted/fragment
    nodes.
    """
    accepted, pvals = [], []
    for cand in cca_active(G):
        if cand.number_of_nodes() < cfg.min_track_hits:
            continue
        coords_by_node, merged = check_close_proximity(cand, cfg)
        if merged:
            vivl_check = [cand.nodes[n]["vivl_id"] for n in coords_by_node]
        else:
            vivl_check = [cand.nodes[n]["vivl_id"] for n in cand.nodes()]
        if len(vivl_check) != len(set(vivl_check)):
            continue
        if len(set(vivl_check)) < cfg.min_track_hits:
            continue
        coords = sorted(coords_by_node.values(), key=lambda c: -c[3])
        coords = rotate_track(coords, cfg.separation_3d_threshold)
        pval, pval_zr = kf_track_fit(coords, cfg)
        if pval >= cfg.track_acceptance_pval and pval_zr >= cfg.track_acceptance_pval:
            accepted.append(set(cand.nodes()))
            pvals.append((pval, pval_zr))

    for nodes in accepted:
        G.remove_nodes_from(nodes)

    # fragment classification per original file (ref :459-467)
    remaining_by_file = {}
    for n in G.nodes():
        remaining_by_file.setdefault(file_of_node[n], []).append(n)
    fragments = []
    for f, nodes in remaining_by_file.items():
        if 0 < len(nodes) < cfg.min_track_hits:
            fragments.append(set(nodes))
    for nodes in fragments:
        G.remove_nodes_from(nodes)
    return {"accepted": accepted, "pvals": pvals, "fragments": fragments}


# --------------------------------------------------------------------------
# full pipeline (run_gnn_trackml_mod.sh:71-148 schedule)
# --------------------------------------------------------------------------

def run_pipeline(G, cfg, file_of_node, neighbour_order=None, succ_order=None):
    """Event conversion tail + the 3-iteration schedule with extraction."""
    seed_states(G, cfg, neighbour_order=neighbour_order)
    initialize_edge_activation(G)
    compute_prior_probabilities(G, "track_state_estimates")
    compute_mixture_weights(G, "track_state_estimates")
    update_degrees(G)

    results = []
    for i in range(1, cfg.num_iterations + 1):
        if i == 1:
            cluster(G, "track_state_estimates",
                    cfg.chi2_threshold_seed, cfg.kl_threshold_seed, cfg)
            update_degrees(G)
            compute_mixture_weights(G, "track_state_estimates")
            compute_prior_probabilities(G, "track_state_estimates")
        elif i % 2 == 0:
            extrapolation_stage(G, cfg, neighbour_order=succ_order)
        else:
            cluster(G, "updated_track_states",
                    cfg.chi2_threshold_updated, cfg.kl_threshold_updated, cfg)
            update_degrees(G)
            compute_mixture_weights(G, "updated_track_states")
            compute_prior_probabilities(G, "updated_track_states")
        res = extract_stage(G, cfg, file_of_node)
        if i % 2 == 0:
            remove_state_metadata(G, cfg)
        results.append(res)
    return results
