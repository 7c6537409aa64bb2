"""Benchmark: the track finder on the full TrackML event, on one GPU.

Prints one JSON line per metric, each naming the device it ran on:
{"metric", "value", "unit", "vs_baseline", "device": {...}}.

Workload: the committed full-event snapshot (data/snapshots
"trackml_full": volumes 7-14, 55,701 nodes, 330,944 directed edges),
float32, default PipelineConfig.

  * message_passing_edges_per_s_full_event — one extrapolation iteration
    (Kalman extrapolate/validate/update over every active directed edge
    plus the double prior/reweight renormalisation), the reference's hot
    stage (SURVEY.md section 3.3);
  * full_pipeline_seconds_full_event — the whole fused 3-iteration
    schedule (run_pipeline_fast's program);
  * stream_events_per_s_full_event — prefetch loader + pipelined
    stream_pipeline over repeated loads of the snapshot.

Times come from the host clock around work that ends in
block_until_ready, after a warm-up call that compiles.  Baselines are the
reference Python pipeline on a CPU at the same scale (BASELINE.md).

Runs on the GPU; JAX_PLATFORMS=cpu runs it on the CPU explicitly, and the
device field then says so.
"""

import json
import sys
import time

# Reference extrapolation stage at volumes 7-14 (single CPU process,
# BASELINE.md "Full event (volumes 7-14)" table): 330,944 directed edges /
# 119 s.
REF_EDGES_PER_S = 2781.0

# Reference wall-clock for the whole 3-iteration schedule at volumes 7-14
# (tools/make_ref_baseline.py --volumes 7 14 --run): start of clustering
# to end of final extraction (BASELINE.md round-3 section).
REF_FULL_PIPELINE_S = 743.0


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def timed(fn, *args, reps: int):
    """Median seconds of fn(*args) over reps calls, after one warm-up."""
    import jax
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2]


def main():
    import jax
    from gnn_track_finding.utils import platform
    platform.require_gpu()
    cache_dir = platform.enable_compile_cache()
    import jax.numpy as jnp

    from gnn_track_finding.config import PipelineConfig
    from gnn_track_finding.data import prefetch, trackml
    from gnn_track_finding.models import pipeline

    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    for line in platform.device_report(cache_dir):
        log(f"[bench] {line}")

    def emit(metric, value, unit, vs_baseline):
        print(json.dumps({"metric": metric, "value": value, "unit": unit,
                          "vs_baseline": vs_baseline, "device": device}),
              flush=True)

    event = "trackml_full"
    cfg = PipelineConfig(min_volume=7, max_volume=14)
    t0 = time.time()
    g, _ = trackml.load_event(event, cfg, dtype=jnp.float32,
                              with_tracker=False)
    log(f"[bench] loaded {g.n_nodes} nodes / {g.n_edges} directed edges "
        f"in {time.time() - t0:.2f}s")

    prep = jax.jit(pipeline.prepare, static_argnums=1)
    clus = jax.jit(pipeline.cluster_stage, static_argnums=(1, 2))
    extrap = jax.jit(pipeline.extrapolation_stage, static_argnums=1)
    gc = jax.block_until_ready(clus(prep(g, cfg), cfg, False))
    dt = timed(extrap, gc, cfg, reps=20)
    edges_per_s = g.n_edges / dt
    log(f"[bench] extrapolation iteration: {dt * 1e3:.3f} ms")
    emit("message_passing_edges_per_s_full_event", edges_per_s, "edges/s",
         edges_per_s / REF_EDGES_PER_S)

    full = lambda gg: pipeline.full_pipeline_packed(
        pipeline._normalize_static(gg), cfg)
    dt_full = timed(full, g, reps=10)
    log(f"[bench] full 3-iteration schedule: {dt_full * 1e3:.3f} ms")
    emit("full_pipeline_seconds_full_event", dt_full, "s",
         REF_FULL_PIPELINE_S / dt_full)

    n_ev = 10
    pipeline.run_pipeline_fast(g, cfg)          # warm the stream's compile
    loader = prefetch.prefetch_trackml([event] * n_ev, cfg,
                                       dtype=jnp.float32, depth=2,
                                       with_tracker=False)
    t0 = time.perf_counter()
    n_cand = sum(len(out.candidates)
                 for out in pipeline.stream_pipeline(loader, cfg))
    ev_per_s = n_ev / (time.perf_counter() - t0)
    log(f"[bench] stream of {n_ev} events: {n_cand} candidates")
    emit("stream_events_per_s_full_event", ev_per_s, "events/s", None)


if __name__ == "__main__":
    main()
