"""Pull-residual analysis of seed edge states.

Re-design of pull_residuals/pull_residuals_stage1.py:63-165: for every pair
of edge states at a node, the normalised parameter differences
(delta / sqrt(var1 + var2)) for a, b, c, tau and the two theta variants,
labelled by whether node and both neighbours share a truth particle.
Computed vectorised from the graph arrays via the in-edge table; theta and
its variance are recomputed from coordinates with the seeding formulas
(helper.py:334-346,427-429) since they are analysis-only quantities.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from gnn_track_finding.config import PipelineConfig
from gnn_track_finding.graph.state import GraphState


def _theta_and_variance(g: GraphState, cfg: PipelineConfig, edges: np.ndarray):
    """theta = arctan(1/tau), theta2 = atan2(dr, dz), and the squared-
    variance-plus-ms term stored by the reference (helper.py:334-346,429)."""
    src = np.asarray(g.src)[edges]
    dst = np.asarray(g.dst)[edges]
    xyzr = np.asarray(g.xyzr)
    z1, r1 = xyzr[dst, 2], xyzr[dst, 3]
    z2, r2 = xyzr[src, 2], xyzr[src, 3]
    dz = z2 - z1
    dr = r2 - r1
    tau = dz / dr
    theta = np.arctan(1.0 / tau)
    theta2 = np.arctan2(dr, dz)

    def sig(z):
        endcap = np.abs(z) >= cfg.endcap_boundary
        sz = np.where(endcap, cfg.sigma0rz, cfg.sigma0rz2)
        sr = np.where(endcap, cfg.sigma0rz2, cfg.sigma0rz)
        return sz, sr

    sz1, sr1 = sig(z1)
    sz2, sr2 = sig(z2)
    prefix = -1.0 / (1.0 + tau * tau)
    inv_dr = 1.0 / (r1 - r2)
    j1 = prefix * inv_dr
    j2 = -prefix * inv_dr
    j3 = -prefix * (z1 - z2) * inv_dr * inv_dr
    j4 = prefix * (z1 - z2) * inv_dr * inv_dr
    cov_theta = (j1 * j1 * sz1 * sz1 + j2 * j2 * sz2 * sz2
                 + j3 * j3 * sr1 * sr1 + j4 * j4 * sr2 * sr2)

    # multiple-scattering term as stored at seeding (helper.py:400-415,429)
    a = np.asarray(g.seed_sv)[edges, 0]
    b = np.asarray(g.seed_sv)[edges, 1]
    x2 = xyzr[src, 0]
    dr_n = r1 - r2
    dz_n = z1 - z2
    sin_t = np.abs(dr_n) / np.hypot(dr_n, dz_n)
    kappa = (2 * a) / (1 + (2 * a * x2 + b) ** 2) ** 1.5
    var_ms = sin_t * cfg.ms_coefficient() * kappa * kappa
    endcap = np.abs(z1) >= cfg.endcap_boundary
    var_ms = np.where(endcap, var_ms * np.abs(dr_n / dz_n), var_ms)
    if cfg.bug_compat:
        variance_theta = cov_theta ** 2 + var_ms   # helper.py:429 squares
    else:
        variance_theta = cov_theta + var_ms
    return theta, theta2, variance_theta


def pull_residuals(g: GraphState, cfg: PipelineConfig) -> Dict[str, np.ndarray]:
    """Arrays pull_a/b/c/tau/theta1/theta2 + truth over all state pairs."""
    tab = np.asarray(g.in_edges)
    sv = np.asarray(g.seed_sv)
    cov = np.asarray(g.seed_cov)
    joint = np.asarray(g.seed_joint)
    jcov = np.asarray(g.seed_joint_cov)
    src = np.asarray(g.src)
    truth = np.asarray(g.truth)

    out = {k: [] for k in ("pull_a", "pull_b", "pull_c", "pull_tau",
                           "pull_theta1", "pull_theta2", "truth")}
    for node in range(g.n_nodes):
        edges = tab[node]
        edges = edges[edges >= 0]
        if len(edges) < 2:
            continue
        th, th2, vth = _theta_and_variance(g, cfg, edges)
        for j in range(len(edges)):
            for k in range(j):
                e1, e2 = edges[j], edges[k]
                d = sv[e1] - sv[e2]
                s = cov[e1] + cov[e2]
                jd = joint[e1] - joint[e2]
                js = jcov[e1] + jcov[e2]
                out["pull_a"].append(d[0] / np.sqrt(s[0, 0]))
                out["pull_b"].append(d[1] / np.sqrt(s[1, 1]))
                out["pull_c"].append(d[2] / np.sqrt(max(s[2, 2], 1e-300)))
                out["pull_tau"].append(jd[2] / np.sqrt(js[2, 2]))
                svth = vth[j] + vth[k]
                out["pull_theta1"].append((th[j] - th[k]) / np.sqrt(svth))
                out["pull_theta2"].append((th2[j] - th2[k]) / np.sqrt(svth))
                t = int(truth[node] == truth[src[e1]] == truth[src[e2]])
                out["truth"].append(t)
    return {k: np.asarray(v) for k, v in out.items()}


def fwhm(values: np.ndarray, bw: float = 0.05) -> float:
    """Full width at half maximum from a Gaussian KDE
    (pull_residuals_stage1.py FWHM-from-KDE approach)."""
    from scipy.stats import gaussian_kde
    if len(values) < 3:
        return float("nan")
    kde = gaussian_kde(values, bw_method=bw)
    lo, hi = np.percentile(values, [1, 99])
    xs = np.linspace(lo, hi, 2048)
    ys = kde(xs)
    half = ys.max() / 2.0
    above = xs[ys >= half]
    return float(above[-1] - above[0]) if len(above) else float("nan")
