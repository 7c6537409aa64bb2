import numpy as np
import jax.numpy as jnp

from gnn_track_finding.config import PipelineConfig
from gnn_track_finding.graph.build import build_graph_state
from gnn_track_finding.models import toymc, pipeline
from gnn_track_finding.ops import extrapolate, metrics
from gnn_track_finding.analysis import stats_harness

CFG = PipelineConfig(node_bucket=64, edge_bucket=256)


def test_linear_toy_event_pipeline():
    ev = toymc.generate_linear_event(num_tracks=6, seed=4)
    assert ev.edge_pairs.shape[0] > 0
    g, _ = build_graph_state(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs, CFG)
    out = pipeline.run_pipeline(g, CFG)
    assert out.graph.n_nodes == ev.xyzr.shape[0]


def test_hit_pair_predictor():
    p = toymc.HitPairPredictor(0.0, 0.5)
    m1 = toymc.GNNMeasurement(1.0, 0.1, 0.0, 1.0)
    m2 = toymc.GNNMeasurement(2.0, 0.2, 0.0, 2.0)     # y0 = 0 -> accept
    assert p.predict(m1, m2)
    m3 = toymc.GNNMeasurement(2.0, 5.0, 0.0, 2.0)     # steep -> |y0| large
    assert not p.predict(m1, m3)


def test_chi2_debug_stream():
    ev = toymc.generate_event(seed=11, num_tracks=16, edge_dphi_window=0.12)
    g, _ = build_graph_state(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs, CFG)
    g = pipeline._prepare_jit(g, CFG)
    g = pipeline.cluster_stage(g, CFG, use_updated=False)
    g2, (chi2, proc) = extrapolate.message_passing(g, CFG, return_debug=True)
    truth, vals = metrics.chi2_truth_dump(g, chi2, proc)
    assert len(truth) == len(vals) == int(np.asarray(proc).sum())
    assert set(np.unique(truth)) <= {0, 1}


def test_stats_harness_small():
    res = stats_harness.accumulate_pvals(num_runs=3, seed=0, cfg=CFG,
                                         num_tracks=8)
    assert (res["pvals_xy"] >= CFG.track_acceptance_pval - 1e-12).all()
    u = stats_harness.uniformity_check(res["pvals_xy"])
    assert "pvalue" in u


def test_reweight_threshold_sweep():
    """The tune_reweight_threshold study (run_tune_reweight_threshold.sh:
    6-18): kept fractions are monotone non-increasing in the threshold,
    threshold 0 keeps everything, and true edges survive at a higher rate
    than false ones at the reference's operating point 0.1.

    The workload (32 tracks, widened dphi/dtau edge gates — the harness
    defaults) is chosen so false edges actually survive into iteration 2:
    the study must carry real background or the sweep discriminates
    nothing."""
    cfg = PipelineConfig(node_bucket=256, edge_bucket=2048)
    res = stats_harness.reweight_threshold_sweep(num_runs=3, seed=2,
                                                 cfg=cfg)
    assert res["weight"].size > 0
    assert (res["truth"] == 0).any(), "degenerate study: no background"
    assert (res["truth"] == 1).any()
    sk, bk, th = res["signal_kept"], res["background_kept"], res["thresholds"]
    assert np.all(np.isfinite(sk)) and np.all(np.isfinite(bk))
    assert np.all(np.diff(sk) <= 1e-12) and np.all(np.diff(bk) <= 1e-12)
    assert sk[0] == 1.0 and bk[0] == 1.0
    i10 = int(np.argmin(np.abs(th - 0.1)))
    assert sk[i10] > bk[i10], (
        "signal must survive the 0.1 operating point at a higher rate "
        f"(signal {sk[i10]:.3f} vs background {bk[i10]:.3f})")
