import numpy as np

from gnn_track_finding.config import PipelineConfig
from gnn_track_finding.calib import training_data, lut
from gnn_track_finding.graph.build import build_graph_state
from gnn_track_finding.models import toymc, pipeline

CFG = PipelineConfig(node_bucket=64, edge_bucket=256)


def test_training_data_shape_and_truth():
    rows = training_data.generate_training_data(num_events=3, seed=7, cfg=CFG,
                                                num_tracks=10)
    assert rows.shape[1] == 4
    kl, emp_var, degree, truth = rows.T
    assert set(np.unique(truth)) <= {0.0, 1.0}
    assert (degree >= 2).all()
    assert np.isfinite(kl).all()
    # true pairs should have smaller KL distances on average
    assert kl[truth == 1].mean() < kl[truth == 0].mean()


def test_trackml_metadata_extractor_matches_host_rows():
    """The batched device extractor (ref extract_metadata_trackml_
    parabolic_model.py:15-99 analog) emits the same row multiset as the
    per-node host loop."""
    import jax.numpy as jnp
    ev = toymc.generate_event(num_tracks=20, seed=5)
    g, _ = build_graph_state(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs,
                             CFG, dtype=jnp.float64)
    g = pipeline._prepare_jit(g, CFG)
    rows_dev = training_data.extract_metadata_trackml(CFG, g=g, block=48)
    rows_host = training_data._pairwise_rows(g, CFG)
    assert rows_dev.shape == rows_host.shape
    a = rows_dev[np.lexsort(rows_dev.T)]
    b = rows_host[np.lexsort(rows_host.T)]
    np.testing.assert_allclose(a, b, rtol=1e-10)


def test_lut_quantile_roundtrip(tmp_path):
    rows = training_data.generate_training_data(num_events=5, seed=1, cfg=CFG,
                                                num_tracks=12)
    table = lut.fit_lut_quantile(rows, feature="emp_var")
    path = str(tmp_path / "empvar.lut")
    table.save(path)
    loaded = lut.KLThresholdLUT.load(
        path, feature="emp_var",
        feature_bin_width=table.feature_bin_width,
        kl_bin_width=table.kl_bin_width)
    np.testing.assert_array_equal(loaded.upper, table.upper)
    # reference artifact format: "i lo hi" rows
    first = open(path).readline().split()
    assert len(first) == 3

    thr = table.thresholds_for(np.array([0.0, 0.01, 1e9]))
    assert thr.shape == (3,)
    assert (thr >= 0).all()


def test_cluster_with_lut_thresholds_runs():
    import jax.numpy as jnp
    rows = training_data.generate_training_data(num_events=3, seed=2, cfg=CFG,
                                                num_tracks=12)
    table = lut.fit_lut_quantile(rows, feature="emp_var")

    ev = toymc.generate_event(seed=11, num_tracks=16, edge_dphi_window=0.12)
    g, _ = build_graph_state(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs, CFG)
    g = pipeline._prepare_jit(g, CFG)
    thr = jnp.asarray(table.thresholds_for(np.asarray(g.grad_stats)[:, 1]))
    out = pipeline.run_pipeline(g, CFG, kl_thresholds=thr)
    assert len(out.candidates) > 0


def test_calib_plots_and_lut_study(tmp_path):
    """Downsample/balancing (downsample.py:6-24), decision-boundary plot
    (train_svm.py:200-275), parabolic-vs-linear comparison, LUT-effect
    confusion study."""
    from gnn_track_finding.calib import plots

    rows = training_data.generate_training_data(num_events=4, seed=3,
                                                cfg=CFG, num_tracks=12)
    sub = plots.downsample(rows, 200, balance=True)
    pos = (sub[:, 3] == 1).sum()
    neg = (sub[:, 3] == 0).sum()
    assert neg <= pos or neg <= 200
    plots.plot_training_scatter(rows, str(tmp_path / "scatter.png"))
    assert (tmp_path / "scatter.png").exists()
    m = plots.plot_decision_boundary(rows, str(tmp_path / "boundary.png"))
    assert (tmp_path / "boundary.png").exists()
    assert 0.0 < m["recall"] <= 1.0

    pv = plots.parabolic_vs_linear(num_events=6, seed=0)
    assert pv["parabolic"]["separation"] > pv["linear"]["separation"]

    eff = plots.lut_effect_study(num_events=2, seed=50, train_events=5)
    assert set(eff) == {"fixed", "lut"}
    for v in eff.values():
        assert 0.0 <= v["precision"] <= 1.0
