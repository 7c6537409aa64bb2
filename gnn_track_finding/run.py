"""CLI runner — the L3 orchestration analog of run_gnn_trackml_mod.sh.

Runs the whole iterative pipeline on one TrackML event (or a toy event) in
a single process with the graph resident on device, then reports
reconstruction efficiency, replacing the bash stage loop + gpickle relay
(run_gnn_trackml_mod.sh:71-167).

Usage:
  python -m gnn_track_finding.run               # TrackML snapshot, volume 7, f64
  python -m gnn_track_finding.run --toy         # toy event
  python -m gnn_track_finding.run --f32 --volumes 7 14 --stream 10
                                                # full event, served path

It runs on the GPU; set JAX_PLATFORMS=cpu to run it on the CPU instead.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--toy", action="store_true", help="run on a toy event")
    parser.add_argument("--f32", action="store_true",
                        help="float32 compute (default float64)")
    parser.add_argument("--iterations", type=int, default=3)
    parser.add_argument("--volumes", type=int, nargs=2, default=None,
                        metavar=("MIN", "MAX"),
                        help="volume range (default: config 7 7)")
    parser.add_argument("--calibrate", action="store_true",
                        help="fit a KL-threshold LUT on toy events and use "
                             "it in clustering (the reference's dead LUT "
                             "feature, wired)")
    parser.add_argument("--json", action="store_true",
                        help="emit one JSON summary line")
    parser.add_argument("--fast", action="store_true",
                        help="production streaming mode: fused one-dispatch "
                             "schedule (run_pipeline_fast) + binary event "
                             "cache; skips the parity tracker / leak "
                             "emulation")
    parser.add_argument("--stream", type=int, default=0, metavar="N",
                        help="stream the event N times through the "
                             "production driver (prefetch loader + "
                             "pipelined stream_pipeline, implies --fast) "
                             "and report sustained events/s")
    args = parser.parse_args()
    if args.stream:
        args.fast = True

    import jax
    if not args.f32:
        # float64: the parity mode (reference numerics)
        jax.config.update("jax_enable_x64", True)
    from gnn_track_finding.utils import platform
    platform.require_gpu()
    platform.enable_compile_cache()

    import jax.numpy as jnp
    import numpy as np

    from gnn_track_finding.config import PipelineConfig
    from gnn_track_finding.models import pipeline, toymc
    from gnn_track_finding.graph.build import build_graph_state

    cfg = PipelineConfig(num_iterations=args.iterations)
    if args.volumes:
        cfg = dataclasses.replace(cfg, min_volume=args.volumes[0],
                                  max_volume=args.volumes[1])
    dtype = jnp.float32 if args.f32 else jnp.float64

    t0 = time.time()
    if args.toy:
        cfg = dataclasses.replace(cfg, node_bucket=256, edge_bucket=1024)
        ev = toymc.generate_event(num_tracks=50, seed=1)
        g, host = build_graph_state(ev.xyzr, ev.vivl, ev.truth,
                                    ev.edge_pairs, cfg, dtype=dtype)
    else:
        from gnn_track_finding.data import snapshots, trackml
        event = snapshots.for_volumes(cfg.min_volume, cfg.max_volume)
        g, host = trackml.load_event(event, cfg, dtype=dtype,
                                     with_tracker=not args.fast)
    t_load = time.time() - t0
    print(f"[load] {g.n_nodes} nodes, {g.n_edges} directed edges, "
          f"K={g.max_degree}, padded ({g.num_padded_nodes}, "
          f"{g.num_padded_edges}) in {t_load:.1f}s")

    kl_thresholds = None
    if args.calibrate:
        from gnn_track_finding.calib import lut, training_data
        t0 = time.time()
        rows = training_data.generate_training_data(num_events=20, seed=0)
        table = lut.fit_lut_quantile(rows, feature="emp_var")
        import numpy as _np
        feat = _np.asarray(
            pipeline._prepare_jit(g, cfg).grad_stats)[:, 1]
        kl_thresholds = jnp.asarray(table.thresholds_for(feat), g.dtype)
        print(f"[calib] quantile LUT fit on {rows.shape[0]} pairs in "
              f"{time.time() - t0:.1f}s; thresholds "
              f"[{float(kl_thresholds.min()):.3g}, "
              f"{float(kl_thresholds.max()):.3g}]")

    if args.stream and not args.toy:
        from gnn_track_finding.data import prefetch
        pipeline.run_pipeline_fast(g, cfg)      # warm compiles
        loader = prefetch.prefetch_trackml(
            [event] * args.stream, cfg, dtype=dtype, depth=2,
            with_tracker=False)
        t0 = time.time()
        n_cand = sum(len(o.candidates)
                     for o in pipeline.stream_pipeline(loader, cfg))
        dt = time.time() - t0
        print(f"[stream] {args.stream} events in {dt:.1f}s = "
              f"{args.stream / dt:.2f} events/s sustained "
              f"({n_cand} candidates)")
        if args.json:
            print(json.dumps({"events": args.stream,
                              "events_per_s": args.stream / dt,
                              "candidates": n_cand}))
        return

    t0 = time.time()
    if args.fast and kl_thresholds is None:
        out = pipeline.run_pipeline_fast(g, cfg)
    else:
        out = pipeline.run_pipeline(g, cfg, kl_thresholds=kl_thresholds,
                                    tracker=getattr(host, "tracker", None))
    t_pipe = time.time() - t0
    print(f"[pipeline] {len(out.candidates)} candidates in {t_pipe:.1f}s "
          f"({g.n_edges * cfg.num_iterations / t_pipe:.0f} edges/s/iter avg)")
    per_it = {}
    for c in out.candidates:
        per_it[c.iteration] = per_it.get(c.iteration, 0) + 1
    print(f"[pipeline] candidates per iteration: {per_it}")

    summary = {"nodes": g.n_nodes, "edges": g.n_edges,
               "candidates": len(out.candidates),
               "pipeline_seconds": t_pipe}

    if args.toy:
        pure = sum(1 for c in out.candidates
                   if len({int(ev.truth[n]) for n in c.nodes}) == 1)
        print(f"[eval] pure candidates: {pure}/{len(out.candidates)}")
        summary["pure"] = pure
    else:
        # the efficiency evaluation reads the particles CSV, which the
        # committed snapshots do not carry
        print("[eval] skipped: efficiency needs the event's particles CSV; "
              "the snapshot has none")

    if args.json:
        print(json.dumps(summary))


if __name__ == "__main__":
    main()
