"""REAL multi-process run of the edge-sharded schedule (2-host analog).

Round-4's residual: multi-host execution had only ever been simulated
inside ONE process (8 virtual devices).  This machine has one host, but
it CAN run a genuine `jax.distributed` job: two separate processes, 4
virtual CPU devices each, Gloo cross-process collectives — exercising
the production bring-up path end-to-end (parallel/multihost.initialize
-> global 8-device mesh spanning a process boundary -> the designed
edge-partition exchanges riding cross-process collectives, the DCN
analog being localhost gRPC/Gloo).

What it does:
  1. single-process reference: volume-7 f64 `full_pipeline`, accepted
     matrix dumped to disk;
  2. spawns 2 worker processes; each initializes jax.distributed
     (num_processes=2), builds the same event, materialises the
     edge-sharded GraphState across the GLOBAL mesh via
     make_array_from_callback, and runs edge_shard.schedule_sharded;
  3. process 0 compares the (replicated) accepted matrix bit-exactly
     against the single-process reference.

Result is recorded in BASELINE.md ("2-process measurement").

Usage: python tools/multiprocess_schedule.py            # full flow
       python tools/multiprocess_schedule.py worker N   # internal
"""

from __future__ import annotations

import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

_os.environ["JAX_PLATFORMS"] = "cpu"
_os.environ["XLA_FLAGS"] = (
    " --xla_force_host_platform_device_count="
    + ("4" if any(a in ("worker", "dp-worker") for a in _sys.argv) else "8"))

import subprocess
import sys
import time

REF_NPY = "/tmp/mp_schedule_ref_accepted.npy"
COORD = "localhost:23457"


def _common_setup():
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from gnn_track_finding.utils import platform
    platform.enable_compile_cache()
    return jax


def _load_event():
    import jax.numpy as jnp

    from gnn_track_finding.config import PipelineConfig
    from gnn_track_finding.data import trackml

    cfg = PipelineConfig(min_volume=7, max_volume=7)
    g, _ = trackml.load_event("trackml_v7", cfg,
                              dtype=jnp.float64, with_tracker=False)
    return g, cfg


def run_single() -> None:
    import numpy as np
    _common_setup()
    from gnn_track_finding.models import pipeline
    g, cfg = _load_event()
    _, acc, _ = pipeline.full_pipeline(g, cfg)
    np.save(REF_NPY, np.asarray(acc))
    print(f"[single] accepted per iter: "
          f"{np.asarray(acc).sum(axis=1).tolist()}")


def run_worker(pid: int) -> None:
    import numpy as np
    jax = _common_setup()
    jax.config.update("jax_cpu_collectives_implementation", "gloo")

    from gnn_track_finding.parallel import multihost
    multihost.initialize(coordinator_address=COORD, num_processes=2,
                         process_id=pid)
    assert jax.process_count() == 2 and len(jax.devices()) == 8
    print(f"[p{pid}] distributed up: {jax.process_count()} processes, "
          f"{len(jax.devices())} global / {len(jax.local_devices())} "
          f"local devices", flush=True)

    from jax.sharding import NamedSharding
    from gnn_track_finding.parallel import edge_shard

    g, cfg = _load_event()
    mesh = edge_shard.edge_mesh(8)          # spans both processes
    routing = edge_shard.build_owner_routing(g, 8)

    # materialise the sharded GraphState on the GLOBAL mesh: every
    # process holds the full host arrays; each device's shard is cut
    # from them by index (the multi-process substitute for device_put)
    specs = edge_shard.graph_pspecs(g)
    def put(x, spec):
        sh = NamedSharding(mesh, spec)
        arr = np.asarray(x)
        return jax.make_array_from_callback(arr.shape, sh,
                                            lambda idx: arr[idx])
    gs = jax.tree.map(put, g, specs)

    t0 = time.time()
    out_g, out_acc = edge_shard.schedule_sharded(cfg, mesh, routing)(gs)
    acc = np.asarray(out_acc)               # replicated -> addressable
    dt = time.time() - t0
    print(f"[p{pid}] sharded schedule over 2 processes: "
          f"accepted per iter {acc.sum(axis=1).tolist()} "
          f"(compile+run {dt:.1f}s)", flush=True)

    if pid == 0:
        ref = np.load(REF_NPY)
        assert np.array_equal(ref.astype(bool), acc.astype(bool)), \
            "accepted matrix differs from single-process reference"
        print("[p0] MULTIPROCESS MATCH: accepted matrix bit-equal to "
              "the single-process full_pipeline", flush=True)


def run_dp_worker(pid: int) -> None:
    """Event-batch DP across processes (SURVEY section 5 multi-host
    model): each process streams ITS OWN slice of the event batch
    entirely on its LOCAL devices — the cross-process link (the DCN
    analog) carries nothing but the final metric reduction."""
    import numpy as np
    jax = _common_setup()
    jax.config.update("jax_cpu_collectives_implementation", "gloo")

    from gnn_track_finding.parallel import multihost
    multihost.initialize(coordinator_address=COORD, num_processes=2,
                         process_id=pid)
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from gnn_track_finding.models import pipeline

    n_events = 4
    lo, hi = multihost.local_event_slice(n_events)
    print(f"[p{pid}] DP slice: events [{lo}, {hi})", flush=True)

    g, cfg = _load_event()
    # pin the whole pipeline to this process's first local device: the
    # per-event compute never crosses the process boundary
    local = jax.local_devices()[0]
    g = jax.device_put(g, local)
    accepted = 0
    t0 = time.time()
    for _ in range(lo, hi):
        out = pipeline.run_pipeline_fast(g, cfg)
        accepted += len(out.candidates)
    dt = time.time() - t0
    print(f"[p{pid}] local stream: {hi - lo} events, {accepted} "
          f"candidates in {dt:.1f}s", flush=True)

    # metric reduction — the ONLY cross-process communication
    n_dev = len(jax.devices())
    mesh = Mesh(np.array(jax.devices()).reshape(2, n_dev // 2),
                ("proc", "dev"))
    part = jax.make_array_from_callback(
        (2,), NamedSharding(mesh, P("proc")),
        lambda idx: np.array([accepted], np.int32))
    total = int(jnp.sum(part))
    print(f"[p{pid}] global accepted (psum over processes): {total}",
          flush=True)
    if pid == 0:
        assert total == 2 * accepted   # both slices ran the same event
        print("[p0] DP MULTIPROCESS OK: per-process streams local, "
              "cross-process link carried only the metric reduction",
              flush=True)


def main() -> None:
    if len(sys.argv) > 1 and sys.argv[1] == "worker":
        run_worker(int(sys.argv[2]))
        return
    if len(sys.argv) > 1 and sys.argv[1] == "dp-worker":
        run_dp_worker(int(sys.argv[2]))
        return
    mode = "dp" if "--dp" in sys.argv else "sharded"
    if mode == "sharded":
        run_single()
    kind = "dp-worker" if mode == "dp" else "worker"
    procs = [subprocess.Popen(
        [sys.executable, __file__, kind, str(pid)],
        stdout=None if pid == 0 else subprocess.DEVNULL,
        stderr=subprocess.STDOUT if pid == 0 else subprocess.DEVNULL)
        for pid in (1, 0)]
    rcs = [p.wait() for p in procs]
    assert rcs == [0, 0], rcs
    print(f"[main] 2-process {mode} schedule OK")


if __name__ == "__main__":
    main()
