"""KL-distance training-data generation for threshold calibration.

Re-design of learn_KL_linear_model/generate_training_data
(generate_events.py:36-176, compute_KL_distance.py:11-87) and the
parabolic-model copy: simulate seeded toy events, seed per-edge track
states with the SAME device kernels the pipeline uses, and emit one row per
in-edge state pair per node:

    kl_dist   pairwise KL distance between the two edge states
    emp_var   empirical variance of the node's xy edge gradients
              (helper.py:446, the LUT feature of empvar.lut)
    degree    number of edge states at the node (the kl_degree.lut feature)
    truth     1 when node and both neighbours share the truth particle
              (compute_KL_distance.py:73-85)

Unlike the reference — which trains on LINEAR 2x2 edge states from its own
simulator copy — the rows here use the production parabolic joint states,
so the calibrated thresholds transfer to the pipeline they gate.
"""

from __future__ import annotations

import numpy as np

from gnn_track_finding.config import PipelineConfig
from gnn_track_finding.graph.build import build_graph_state
from gnn_track_finding.models import pipeline, toymc


def _pairwise_rows(g, cfg: PipelineConfig) -> np.ndarray:
    """Rows (kl_dist, emp_var, degree, truth) for every state pair."""
    import jax.numpy as jnp  # noqa: F401
    tab = np.asarray(g.in_edges)
    src = np.asarray(g.src)
    truth = np.asarray(g.truth)
    joint = np.asarray(g.seed_joint, np.float64)
    jcov = np.asarray(g.seed_joint_cov, np.float64)
    grad = np.asarray(g.grad_stats)

    rows = []
    for node in range(g.n_nodes):
        edges = tab[node]
        edges = edges[edges >= 0]
        d = len(edges)
        if d <= 1:
            continue
        emp_var = grad[node, 1]
        means = joint[edges]
        covs = jcov[edges]
        invs = np.linalg.inv(covs)
        nb_truth = truth[src[edges]]
        node_truth = truth[node]
        for i in range(d):
            for j in range(i):
                dc = covs[i] - covs[j]
                di = invs[j] - invs[i]
                trace = np.trace(dc * di)           # elementwise (ref quirk)
                dm = means[i] - means[j]
                kl = trace + dm @ (invs[i] + invs[j]) @ dm
                t = int(node_truth == nb_truth[i] == nb_truth[j])
                rows.append((kl, emp_var, d, t))
    return np.asarray(rows, np.float64)


def extract_metadata_trackml(cfg: PipelineConfig | None = None,
                             g=None, block: int = 2048) -> np.ndarray:
    """KL training rows from the REAL TrackML event graph.

    The reference extracts calibration metadata from the production event
    too (learn_KL_parabolic_model/src/generate_training_data/
    extract_metadata_trackml_parabolic_model.py:15-99): for every node
    with >1 seed state, one row per state pair with the pairwise KL
    distance (elementwise-trace form, ibid.:15-17), the node's empirical
    xy-gradient variance ('xy_edge_gradient_mean_var'[1], ibid.:60), the
    state count, and truth = 1 when the node and both neighbours share
    the truth particle (ibid.:85-99).

    Where the reference loops per node/pair in Python, this runs one
    batched (block, K, K) device kernel per node block over the in-edge
    table and filters the masked pairs host-side.  Returns (rows, 4) =
    (kl_dist, emp_var, degree, truth) like the toy generator.

    g: optionally a pre-seeded GraphState (skips the event load).
    """
    import jax
    import jax.numpy as jnp

    from gnn_track_finding.ops import linalg

    cfg = cfg or PipelineConfig()
    if g is None:
        from gnn_track_finding.data import snapshots, trackml
        g, _ = trackml.load_event(
            snapshots.for_volumes(cfg.min_volume, cfg.max_volume), cfg,
            dtype=jnp.float64)
        g = pipeline._prepare_jit(g, cfg)

    nb_truth_e = g.truth[g.src]                        # (E,) per edge

    @jax.jit
    def block_rows(tab, node_truth, emp_var):
        valid = tab >= 0
        e = jnp.maximum(tab, 0)
        packed = jnp.concatenate([
            g.seed_joint, g.seed_joint_cov.reshape(-1, 9),
            nb_truth_e[:, None].astype(g.dtype)], axis=1)
        pk = packed[e]                                  # (B, K, 13)
        sv = jnp.where(valid[..., None], pk[..., 0:3], 0.0)
        cov = jnp.where(valid[..., None, None],
                        pk[..., 3:12].reshape(*e.shape, 3, 3),
                        jnp.eye(3, dtype=g.dtype))
        nb_truth = pk[..., 12].astype(jnp.int32)
        kl = linalg.kl_distance(sv[:, :, None], cov[:, :, None],
                                sv[:, None], cov[:, None],
                                bug_compat=cfg.bug_compat)   # (B, K, K)
        k = tab.shape[1]
        tri = jnp.arange(k)[:, None] > jnp.arange(k)[None, :]
        ok = tri[None] & valid[:, :, None] & valid[:, None, :]
        same = ((nb_truth[:, :, None] == nb_truth[:, None, :])
                & (nb_truth[:, :, None] == node_truth[:, None, None]))
        degree = jnp.sum(valid, axis=1)
        return kl, ok, same, degree

    tab_np = np.asarray(g.in_edges)
    truth_np = np.asarray(g.truth)
    grad_np = np.asarray(g.grad_stats)
    all_rows = []
    for start in range(0, g.n_nodes, block):
        stop = min(start + block, g.n_nodes)
        kl, ok, same, degree = jax.device_get(block_rows(
            jnp.asarray(tab_np[start:stop]),
            jnp.asarray(truth_np[start:stop]),
            jnp.asarray(grad_np[start:stop, 1])))
        b_idx, i_idx, j_idx = np.nonzero(ok & (degree > 1)[:, None, None])
        if not b_idx.size:
            continue
        all_rows.append(np.stack([
            kl[b_idx, i_idx, j_idx],
            grad_np[start + b_idx, 1],
            degree[b_idx].astype(np.float64),
            same[b_idx, i_idx, j_idx].astype(np.float64)], axis=1))
    return (np.concatenate(all_rows, axis=0) if all_rows
            else np.zeros((0, 4)))


def generate_training_data(num_events: int = 50, seed: int = 0,
                           cfg: PipelineConfig | None = None,
                           num_tracks: int = 20) -> np.ndarray:
    """(rows, 4) array over `num_events` seeded toy events."""
    cfg = cfg or PipelineConfig(node_bucket=256, edge_bucket=1024)
    all_rows = []
    for ev_i in range(num_events):
        ev = toymc.generate_event(num_tracks=num_tracks, seed=seed + ev_i)
        g, _ = build_graph_state(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs, cfg)
        g = pipeline._prepare_jit(g, cfg)
        rows = _pairwise_rows(g, cfg)
        if rows.size:
            all_rows.append(rows)
    return np.concatenate(all_rows, axis=0)


def save_training_csv(rows: np.ndarray, path: str) -> None:
    header = "kl_dist,emp_var,degree,truth"
    np.savetxt(path, rows, delimiter=",", header=header, comments="")
