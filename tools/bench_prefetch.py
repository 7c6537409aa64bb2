"""Sustained multi-event throughput: the production streaming path.

Proves the PP-analog row of SURVEY.md section 2.3 end-to-end: the
double-buffered host loader (data/prefetch.py) overlaps event i+1's
ingest + host->device transfer with event i's device compute, and the
fused driver (models/pipeline.run_pipeline_fast) runs the whole
3-iteration schedule as ONE jitted program per event — no per-stage
host round trips, no host CCA pulls.  The reference ingests serially
before any compute starts (event_conversion.py:15-123).

Events are loads of the committed snapshot that covers --volumes.

Modes:
  fast (default) — run_pipeline_fast: the production stream.
  driver         — the stage-by-stage run_pipeline with host CCA (the
                   parity-capable driver).

Each mode reports the serial load->run loop and prefetch depth=2.  Runs
on the GPU (JAX_PLATFORMS=cpu runs it on the CPU explicitly).

Usage: python tools/bench_prefetch.py [--n 10] [--mode fast|driver]
"""

from __future__ import annotations

import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import sys
import time


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=10)
    ap.add_argument("--volumes", nargs=2, type=int, default=[7, 14])
    ap.add_argument("--mode", choices=["fast", "driver"], default="fast")
    ap.add_argument("--stream-depth", type=int, default=1,
                    help="dispatched-but-unread events kept in flight "
                         "by stream_pipeline (fast mode)")
    ap.add_argument("--load-depth", type=int, default=2,
                    help="prefetch loader depth (events loading ahead)")
    ap.add_argument("--workers", type=int, default=1,
                    help="prefetch loader threads")
    args = ap.parse_args()

    import jax
    from gnn_track_finding.utils import platform
    platform.require_gpu()
    platform.enable_compile_cache()
    import jax.numpy as jnp

    from gnn_track_finding.config import PipelineConfig
    from gnn_track_finding.data import prefetch, snapshots, trackml
    from gnn_track_finding.models import pipeline

    cfg = PipelineConfig(min_volume=args.volumes[0],
                         max_volume=args.volumes[1])
    fast = args.mode == "fast"
    event = snapshots.for_volumes(*args.volumes)
    run = pipeline.run_pipeline_fast if fast else pipeline.run_pipeline

    # warm every compile (prepare/stages/extract) outside the timing
    t0 = time.time()
    g, _ = trackml.load_event(event, cfg, dtype=jnp.float32,
                              with_tracker=not fast)
    out = run(g, cfg)
    print(f"[prefetch] mode={args.mode} event={event} "
          f"warmup load+run {time.time() - t0:.1f}s, "
          f"{len(out.candidates)} candidates, "
          f"backend={jax.default_backend()}", file=sys.stderr)

    paths = [event] * args.n

    # (a) serial: ingest fully, then compute, per event
    t0 = time.time()
    total = 0
    for p in paths:
        g, _ = trackml.load_event(p, cfg, dtype=jnp.float32,
                                  with_tracker=not fast)
        total += len(run(g, cfg).candidates)
    dt_serial = time.time() - t0
    print(f"serial    : {args.n} events in {dt_serial:.1f}s = "
          f"{args.n / dt_serial:.3f} events/s  ({total} candidates)")

    # (b) prefetch depth=2: ingest of event i+1 rides under event i's
    # device compute; in fast mode the streaming driver additionally
    # pipelines dispatch vs readback (models/pipeline.stream_pipeline)
    t0 = time.time()
    total = 0
    loader = prefetch.prefetch_trackml(paths, cfg, dtype=jnp.float32,
                                       depth=args.load_depth,
                                       with_tracker=not fast,
                                       workers=args.workers)
    if fast:
        for out in pipeline.stream_pipeline(loader, cfg,
                                            depth=args.stream_depth):
            total += len(out.candidates)
    else:
        for g in loader:
            total += len(run(g, cfg).candidates)
    dt_pre = time.time() - t0
    print(f"prefetch=2: {args.n} events in {dt_pre:.1f}s = "
          f"{args.n / dt_pre:.3f} events/s  ({total} candidates)")
    print(f"speedup x{dt_serial / dt_pre:.2f}")


if __name__ == "__main__":
    main()
