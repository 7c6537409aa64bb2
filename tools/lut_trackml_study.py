"""Per-node KL LUT calibrated on REAL TrackML data — the reference's dead
feature exercised on its intended input.

The reference plumbs a LUT path into clustering but never reads it
(run_gnn_trackml_mod.sh:24, clustering.py:386,400; consumption commented
out in clustering_updated_states_test.py:176,233); its calibration chain
includes a TrackML metadata extractor
(learn_KL_parabolic_model/src/generate_training_data/
extract_metadata_trackml_parabolic_model.py:15-99) precisely so the LUT
could be trained on production emp-var spread.  The round-4 toy study
was an honest negative: toy emp-var collapses to one feature bin, so
per-node thresholds never differentiated (BASELINE.md clean-mode
section).  This study closes the loop on the real event:

  1. extract (kl, emp_var, degree, truth) rows from the full event
     (calib/training_data.extract_metadata_trackml; volume 7 alone has
     zero true pairs);
  2. fit the quantile LUT at recall 0.95 on the emp-var feature and
     report whether per-node thresholds actually differentiate (bins
     occupied, threshold spread across nodes);
  3. run the iteration-1 clustering with fixed vs per-node thresholds
     and score the edge-deactivation decisions against truth
     (ops/metrics.edge_decision_confusion) plus the downstream
     candidate counts over the full 3-iteration schedule.

Results + conclusion are committed in docs/DESIGN.md.

Usage: python tools/lut_trackml_study.py [--volumes 7 14]
(on the GPU; JAX_PLATFORMS=cpu runs it on the CPU)
"""

from __future__ import annotations

import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import time


def main() -> None:
    ap = argparse.ArgumentParser()
    # calibration needs positives: volume 7 alone has ZERO true pairs
    # (0.23% of its edges connect same-particle hits); the full event
    # yields 177 true / 1.96M rows (0.009%)
    ap.add_argument("--volumes", nargs=2, type=int, default=[7, 14])
    args = ap.parse_args()

    import jax
    jax.config.update("jax_enable_x64", True)
    from gnn_track_finding.utils import platform
    platform.require_gpu()
    platform.enable_compile_cache()
    import numpy as np
    import jax.numpy as jnp

    from gnn_track_finding.calib import lut as lutmod
    from gnn_track_finding.calib import training_data
    from gnn_track_finding.config import PipelineConfig
    from gnn_track_finding.data import snapshots, trackml
    from gnn_track_finding.models import pipeline
    from gnn_track_finding.ops import metrics

    cfg = PipelineConfig(min_volume=args.volumes[0],
                         max_volume=args.volumes[1])
    t0 = time.time()
    g0, _ = trackml.load_event(
        snapshots.for_volumes(cfg.min_volume, cfg.max_volume), cfg,
                               dtype=jnp.float64, with_tracker=False)
    gp = pipeline._prepare_jit(g0, cfg)
    print(f"[lut] volumes {args.volumes}: {g0.n_nodes} nodes / "
          f"{g0.n_edges} edges, prepared in {time.time() - t0:.1f}s")

    # 1. real-event calibration rows (drop NaN emp-var rows: nodes whose
    # gradient variance is undefined — fewer than 2 in-edges)
    rows = training_data.extract_metadata_trackml(cfg, g=gp)
    n_raw = len(rows)
    rows = rows[np.isfinite(rows).all(axis=1)]
    kl, emp_var, deg, truth = rows.T
    print(f"[lut] {n_raw} pair rows ({n_raw - len(rows)} NaN-var dropped), "
          f"{int(truth.sum())} true ({truth.mean() * 100:.4f}%); "
          f"emp_var spread p1/p50/p99 = "
          f"{np.percentile(emp_var, 1):.4g} / "
          f"{np.percentile(emp_var, 50):.4g} / "
          f"{np.percentile(emp_var, 99):.4g}")
    if truth.sum():
        print(f"[lut] KL separation on real labels: true p50 "
              f"{np.percentile(kl[truth == 1], 50):.3g} vs false p50 "
              f"{np.percentile(kl[truth == 0], 50):.3g} "
              f"(toy separation was ~2,400x — DESIGN.md)")

    # 2. quantile LUT at the reference's recall point
    lut = lutmod.fit_lut_quantile(rows, feature="emp_var", recall=0.95)
    node_var = np.asarray(gp.grad_stats)[:, 1]
    thr_nodes = lut.thresholds_for(node_var)
    alive = np.asarray(gp.node_mask)
    occupied = np.unique(np.clip(
        (node_var[alive] / lut.feature_bin_width).astype(int),
        0, len(lut.upper) - 1))
    uniq_thr = np.unique(thr_nodes[alive])
    print(f"[lut] feature bins occupied by nodes: {len(occupied)}/"
          f"{len(lut.upper)}; distinct per-node thresholds: "
          f"{len(uniq_thr)} (min {uniq_thr.min():.3g}, "
          f"max {uniq_thr.max():.3g}; fixed scalar = "
          f"{cfg.kl_threshold_seed})")

    # 3. clustering decisions at volume 7 (cheap compiled shapes) with
    # thresholds from the full-event calibration: fixed vs per-node
    cfg7 = PipelineConfig(min_volume=7, max_volume=7)
    g7, _ = trackml.load_event("trackml_v7", cfg7,
                               dtype=jnp.float64, with_tracker=False)
    gp7 = pipeline._prepare_jit(g7, cfg7)
    thr7 = jnp.asarray(lut.thresholds_for(
        np.asarray(gp7.grad_stats)[:, 1]), gp7.dtype)

    g_fixed = pipeline._stage_jit(gp7, cfg7, 1, None)
    g_lut = pipeline._stage_jit(gp7, cfg7, 1, thr7)
    cm_fixed = metrics.edge_decision_confusion(gp7, g_fixed)
    cm_lut = metrics.edge_decision_confusion(gp7, g_lut)
    mf = int(np.asarray(g_fixed.has_merged).sum())
    ml = int(np.asarray(g_lut.has_merged).sum())
    print(f"[lut] vol-7 fixed : merged {mf}, deactivation precision "
          f"{cm_fixed.precision:.4f} recall {cm_fixed.recall:.4f} "
          f"(tp {cm_fixed.tp} fp {cm_fixed.fp})")
    print(f"[lut] vol-7 LUT   : merged {ml}, deactivation precision "
          f"{cm_lut.precision:.4f} recall {cm_lut.recall:.4f} "
          f"(tp {cm_lut.tp} fp {cm_lut.fp})")

    # 4. full-schedule candidate effect (volume 7)
    out_fixed = pipeline.run_pipeline(g7, cfg7)
    out_lut = pipeline.run_pipeline(g7, cfg7, kl_thresholds=thr7)
    print(f"[lut] vol-7 full schedule candidates: fixed "
          f"{len(out_fixed.candidates)}, LUT {len(out_lut.candidates)}")


if __name__ == "__main__":
    main()
