"""Event-scale sharded-schedule validation + full-iteration collective census.

The edge-partitioned schedule is validated on 20-track toys by the
tests; here it runs on REAL data — TrackML
volume 7 (8,748 nodes / 29,532 directed edges after padding buckets) at
float64 on the 8-virtual-device CPU mesh — and is checked against the
single-device `full_pipeline` (masks/integers exact, floats allclose).
It then compiles each sharded iteration type and reports the collective
census (kind, count, operand bytes) of the round-4 designed exchanges:
the clustering owner-routed all_to_all (E x 116 B packed rows), the CCA
per-round (N,) pmin, and the metadata/prior owner exchange — extending
the round-3 extrapolation-only census (docs/DESIGN.md).

Usage: python tools/census_full_schedule.py   (forces CPU + 8 devices)
"""

from __future__ import annotations

import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

_os.environ["JAX_PLATFORMS"] = "cpu"
_os.environ["XLA_FLAGS"] = (_os.environ.get("XLA_FLAGS", "")
                            + " --xla_force_host_platform_device_count=8")

import time

from profile_edge_shard import collective_stats  # noqa: E402


def main() -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from gnn_track_finding.utils import platform
    platform.enable_compile_cache()
    import numpy as np

    from gnn_track_finding.config import PipelineConfig
    from gnn_track_finding.data import trackml
    from gnn_track_finding.models import pipeline
    from gnn_track_finding.parallel import edge_shard

    cfg = PipelineConfig(min_volume=7, max_volume=7)
    t0 = time.time()
    g, _ = trackml.load_event("trackml_v7", cfg,
                              with_tracker=False)
    print(f"[census] volume 7: {g.n_nodes} nodes / {g.n_edges} edges "
          f"(padded {g.num_padded_nodes}/{g.num_padded_edges}), "
          f"dtype {g.dtype}, loaded {time.time() - t0:.1f}s")

    # ---- single-device truth ----
    t0 = time.time()
    ref_g, ref_acc, _ = pipeline.full_pipeline(g, cfg)
    ref_acc = np.asarray(ref_acc)
    print(f"[census] single-device full_pipeline {time.time() - t0:.1f}s "
          f"(accepted per iter: {ref_acc.sum(axis=1).tolist()})")

    # ---- sharded schedule at event scale ----
    mesh = edge_shard.edge_mesh(8)
    routing = edge_shard.build_owner_routing(g, 8)
    gs = edge_shard.shard_graph(g, mesh)
    t0 = time.time()
    out_g, out_acc = edge_shard.schedule_sharded(cfg, mesh, routing)(gs)
    out_acc = np.asarray(out_acc)
    print(f"[census] sharded schedule (8 shards) {time.time() - t0:.1f}s "
          f"(accepted per iter: {out_acc.sum(axis=1).tolist()})")

    exact = 0
    for name in ("node_mask", "active", "has_merged", "has_updated",
                 "degree", "component"):
        a, b = np.asarray(getattr(ref_g, name)), np.asarray(
            getattr(out_g, name))
        assert np.array_equal(a, b), f"{name} differs"
        exact += 1
    np.testing.assert_array_equal(ref_acc, out_acc)
    for name in ("merged_state", "merged_prior", "upd_sv", "upd_weight",
                 "seed_weight", "seed_prior"):
        a, b = np.asarray(getattr(ref_g, name)), np.asarray(
            getattr(out_g, name))
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12,
                                   err_msg=name)
    print(f"[census] EVENT-SCALE MATCH: {exact} mask/int arrays exact, "
          f"accepted matrix exact, float states allclose(1e-9)")

    # ---- collective census per sharded iteration type ----
    rows = []
    for i, label in ((1, "iteration 1 (clustering + extract/CCA)"),
                     (2, "iteration 2 (extrapolation + extract + metadata)"),
                     (3, "iteration 3 (clustering + extract/CCA)")):
        fn = edge_shard.iteration_sharded(cfg, mesh, i, routing)
        txt = fn.lower(gs).compile().as_text()
        stats = collective_stats(txt)
        rows.append((label, stats))
        total = sum(b for _, b in stats.values())
        pretty = ", ".join(f"{k} x{c} ({b/1e6:.2f} MB)"
                           for k, (c, b) in sorted(stats.items()))
        print(f"[census] {label}: {pretty}  | total {total/1e6:.2f} MB")

    print("\nMarkdown for DESIGN.md:\n")
    print("| sharded iteration | collectives (operand bytes, volume 7 "
          "f64, 8 shards) |")
    print("|---|---|")
    for label, stats in rows:
        total = sum(b for _, b in stats.values())
        pretty = ", ".join(f"{k} x{c} ({b/1e6:.2f} MB)"
                           for k, (c, b) in sorted(stats.items()))
        print(f"| {label} | {pretty} = **{total/1e6:.2f} MB** |")


if __name__ == "__main__":
    main()
