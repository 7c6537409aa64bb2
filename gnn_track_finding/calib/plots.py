"""Calibration analysis: downsampling, decision-boundary plots, and the
LUT-effect study.

Covers the reference's analysis conveniences around the learn_KL pipeline:

  * downsample + class balancing + (kl_dist, emp_var) scatter —
    learn_KL_parabolic_model/src/generate_training_data/downsample.py:6-24
    and its module-level plotting;
  * SVM decision-boundary plots at the chosen operating point — the
    plotting half of learn_KL_linear_model/SVM_training_predictions/
    train_svm.py:200-275;
  * parabolic-vs-linear training-data comparison — the reference keeps two
    whole copies of the calibration chain (learn_KL_linear_model/ and
    learn_KL_parabolic_model/) to compare the state models;
  * LUT-effect study (new; the reference plumbs its LUT into clustering
    but never reads it, SURVEY.md section 2.2): clustering confusion
    metrics with the calibrated per-node thresholds vs the fixed CLI
    thresholds.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from gnn_track_finding.config import PipelineConfig


def downsample(rows: np.ndarray, max_size: int, seed: int = 0,
               balance: bool = True) -> np.ndarray:
    """Random row subsample + optional class balancing (downsample.py:6-24:
    the reference samples with replacement and balances false pairs down
    to the true-pair count)."""
    rng = np.random.default_rng(seed)
    if len(rows) > max_size:
        rows = rows[rng.choice(len(rows), max_size, replace=True)]
    if not balance:
        return rows
    truth = rows[:, 3]
    pos = rows[truth == 1]
    neg = rows[truth == 0]
    if len(neg) > len(pos) and len(pos):
        neg = neg[rng.choice(len(neg), len(pos), replace=True)]
    return np.concatenate([pos, neg], axis=0)


def plot_training_scatter(rows: np.ndarray, path: str,
                          feature: str = "emp_var") -> None:
    """(feature, kl_dist) scatter by truth label (downsample.py plotting)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    kl, emp_var, degree, truth = rows.T
    feat = emp_var if feature == "emp_var" else degree
    fig = plt.figure(figsize=(10, 7))
    plt.scatter(feat[truth == 0], kl[truth == 0], marker="o", s=8,
                alpha=0.5, label="0")
    plt.scatter(feat[truth == 1], kl[truth == 1], marker="x", s=10,
                label="1")
    plt.xlabel(feature)
    plt.ylabel("pairwise KL distance")
    plt.yscale("symlog")
    plt.legend(loc="best")
    fig.savefig(path, dpi=100)
    plt.close(fig)


def plot_decision_boundary(rows: np.ndarray, path: str,
                           feature: str = "emp_var",
                           recall: float = 0.95) -> Dict[str, float]:
    """Train the poly-3 SVC at the recall<=0.95 operating point and plot
    its accepted region over the (feature, kl) plane with the test split
    scattered on top (train_svm.py:200-275 plotting half).  Returns the
    operating-point metrics."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from sklearn.metrics import precision_recall_curve
    from sklearn.model_selection import train_test_split
    from sklearn.svm import SVC

    kl, emp_var, degree, truth = rows.T
    feat = emp_var if feature == "emp_var" else degree
    kl_clip = float(np.percentile(kl[truth == 1], 99.5)) or 1.0
    f_clip = float(np.percentile(feat, 99)) or 1.0
    X = np.stack([np.minimum(kl, kl_clip) / kl_clip,
                  np.minimum(feat, f_clip) / f_clip], axis=1)
    y = truth.astype(int)
    X_tr, X_te, y_tr, y_te = train_test_split(X, y, test_size=0.3,
                                              random_state=0, stratify=y)
    clf = SVC(kernel="poly", degree=3, C=0.1, gamma=0.1,
              class_weight="balanced", max_iter=200000)
    clf.fit(X_tr, y_tr)
    scores = clf.decision_function(X_te)
    p, r, thresholds = precision_recall_curve(y_te, scores)
    order = np.argsort(-r[:-1])
    idx = next((i for i in order if r[i] <= recall), order[-1])
    thr = float(thresholds[idx])

    gx, gy = np.meshgrid(np.linspace(0, 1, 200), np.linspace(0, 1, 200))
    zz = clf.decision_function(
        np.stack([gy.ravel(), gx.ravel()], axis=1)).reshape(gx.shape)
    fig = plt.figure(figsize=(10, 7))
    plt.contourf(gx * f_clip, gy * kl_clip, (zz >= thr).astype(float),
                 levels=[-0.5, 0.5, 1.5], alpha=0.25, colors=["r", "g"])
    plt.contour(gx * f_clip, gy * kl_clip, zz, levels=[thr], colors="k")
    sel0, sel1 = y_te == 0, y_te == 1
    plt.scatter(X_te[sel0, 1] * f_clip, X_te[sel0, 0] * kl_clip,
                marker="o", s=8, alpha=0.5, label="0")
    plt.scatter(X_te[sel1, 1] * f_clip, X_te[sel1, 0] * kl_clip,
                marker="x", s=10, label="1")
    plt.xlabel(feature)
    plt.ylabel("pairwise KL distance")
    plt.legend(loc="best")
    plt.title(f"poly-3 SVC decision boundary @ recall<= {recall}")
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return {"threshold": thr, "recall": float(r[idx]),
            "precision": float(p[idx])}


def parabolic_vs_linear(num_events: int = 20, seed: int = 0,
                        out_dir: Optional[str] = None) -> Dict[str, Dict]:
    """Compare KL training distributions of the parabolic production model
    vs the reference's linear toy model (the two learn_KL_* copies).

    Returns per-model summary stats of true/false-pair KL separation; if
    out_dir is given, writes side-by-side scatter plots.
    """
    import jax.numpy as jnp

    from gnn_track_finding.calib import training_data
    from gnn_track_finding.graph.build import build_graph_state
    from gnn_track_finding.models import pipeline, toymc

    cfg = PipelineConfig(node_bucket=256, edge_bucket=1024)
    para = training_data.generate_training_data(num_events=num_events,
                                                seed=seed, cfg=cfg)
    lin_rows = []
    for i in range(num_events):
        ev = toymc.generate_linear_event(seed=seed + i)
        g, _ = build_graph_state(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs,
                                 cfg, dtype=jnp.float64)
        g = pipeline._prepare_jit(g, cfg)
        rows = training_data._pairwise_rows(g, cfg)
        if rows.size:
            lin_rows.append(rows)
    lin = np.concatenate(lin_rows, axis=0)

    def stats(rows):
        kl, _, _, truth = rows.T
        t, f = kl[truth == 1], kl[truth == 0]
        sep = (np.median(f) / max(np.median(t), 1e-30)
               if len(t) and len(f) else np.nan)
        return {"n": len(kl), "true_kl_median": float(np.median(t)),
                "false_kl_median": float(np.median(f)),
                "separation": float(sep)}

    out = {"parabolic": stats(para), "linear": stats(lin)}
    if out_dir:
        plot_training_scatter(para, f"{out_dir}/kl_scatter_parabolic.png")
        plot_training_scatter(lin, f"{out_dir}/kl_scatter_linear.png")
    return out


def lut_effect_study(num_events: int = 10, seed: int = 100,
                     train_events: int = 30) -> Dict[str, Dict]:
    """Quantify the calibrated LUT's effect on clustering edge decisions
    vs the fixed CLI threshold (the feature the reference plumbs but never
    reads, clustering.py:386,400).

    Runs the seed-state clustering round on held-out toy events twice —
    fixed KL threshold vs per-node LUT thresholds — and scores each
    against truth with the reference's confusion semantics
    (clustering.py:317-321).  Returns confusion rates for both.
    """
    import jax.numpy as jnp

    from gnn_track_finding.calib import lut, training_data
    from gnn_track_finding.graph.build import build_graph_state
    from gnn_track_finding.models import pipeline, toymc
    from gnn_track_finding.ops import metrics

    cfg = PipelineConfig(node_bucket=256, edge_bucket=1024)
    rows = training_data.generate_training_data(num_events=train_events,
                                                seed=seed, cfg=cfg)
    table = lut.fit_lut_quantile(rows, feature="emp_var")

    agg = {"fixed": None, "lut": None}
    for ev_i in range(num_events):
        ev = toymc.generate_event(num_tracks=16, seed=seed + 1000 + ev_i)
        g, _ = build_graph_state(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs,
                                 cfg, dtype=jnp.float64)
        g = pipeline._prepare_jit(g, cfg)
        thr = jnp.asarray(
            table.thresholds_for(np.asarray(g.grad_stats)[:, 1]), g.dtype)
        for name, kl_thr in (("fixed", None), ("lut", thr)):
            g2 = pipeline._stage_jit(g, cfg, 1, kl_thr)
            cm = metrics.edge_decision_confusion(g, g2)
            if agg[name] is None:
                agg[name] = cm
            else:
                prev = agg[name]
                agg[name] = type(cm)(tp=prev.tp + cm.tp, fp=prev.fp + cm.fp,
                                     tn=prev.tn + cm.tn, fn=prev.fn + cm.fn)
    return {name: cm.rates() for name, cm in agg.items()}
