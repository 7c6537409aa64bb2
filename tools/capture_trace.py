"""Capture a JAX profiler trace of the fused schedule (SURVEY section 5).

The reference's only tracing is bash $SECONDS stage stamps
(run_gnn_trackml_mod.sh:44-46,171-186); utils/timing.py reproduces that
artifact, and this tool adds a real jax.profiler trace (device ops,
host dispatch, transfers) of one fused 3-iteration schedule on the
snapshot that covers --volumes, viewable in TensorBoard / Perfetto.

Usage: python tools/capture_trace.py [--out /tmp/gnn_trace] [--volumes 7 14]
"""

from __future__ import annotations

import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import glob
import time


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="/tmp/gnn_trace")
    ap.add_argument("--volumes", nargs=2, type=int, default=[7, 14])
    args = ap.parse_args()

    import jax
    from gnn_track_finding.utils import platform
    platform.require_gpu()
    platform.enable_compile_cache()
    import jax.numpy as jnp

    from gnn_track_finding.config import PipelineConfig
    from gnn_track_finding.data import snapshots, trackml
    from gnn_track_finding.models import pipeline

    cfg = PipelineConfig(min_volume=args.volumes[0],
                         max_volume=args.volumes[1])
    g, _ = trackml.load_event(snapshots.for_volumes(*args.volumes), cfg,
                              dtype=jnp.float32, with_tracker=False)
    # warm the compile outside the trace
    out = pipeline.run_pipeline_fast(g, cfg)
    print(f"[trace] warm run: {len(out.candidates)} candidates "
          f"(backend={jax.default_backend()})")

    with jax.profiler.trace(args.out):
        with jax.profiler.TraceAnnotation("full_schedule"):
            jax.block_until_ready(pipeline.full_pipeline_results(g, cfg))

    files = glob.glob(args.out + "/**/*", recursive=True)
    total = sum(_os.path.getsize(f) for f in files if _os.path.isfile(f))
    print(f"[trace] wrote {len(files)} files / {total / 1e6:.1f} MB "
          f"under {args.out} (open with TensorBoard or Perfetto)")
    assert total > 0, "trace capture produced no data"


if __name__ == "__main__":
    main()
