"""Multi-host initialization and event distribution.

The reference has no distributed backend whatsoever (SURVEY.md section
2.3).  Here `jax.distributed.initialize` brings up the JAX runtime across
hosts; the global mesh spans every GPU with axes ("data", "edge"); each
host feeds its local shard of the event batch, so the network between
hosts carries only event distribution and metric reduction, while
per-event communication stays on the GPUs of one host (NVLink).

The tests exercise it on a simulated CPU mesh (tests/test_parallel.py,
__graft_entry__.dryrun_multichip); chip_smoke.py --multi runs the
data-parallel and edge-partitioned paths on four GPUs of one host.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """jax.distributed.initialize with env-var fallbacks (no-op when
    single-process)."""
    if num_processes in (None, 1):
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def global_mesh(data_axis: Optional[int] = None) -> Mesh:
    """Mesh over all global devices: ("data", "edge").

    data axis defaults to the number of processes (one event-batch shard
    per host) so edge sharding stays inside each host's GPUs — boundary
    node-state exchange never crosses hosts.
    """
    devices = jax.devices()
    n = len(devices)
    data = data_axis or max(jax.process_count(), 1)
    while n % data != 0:
        data -= 1
    mesh_devices = np.asarray(devices).reshape(data, n // data)
    return Mesh(mesh_devices, ("data", "edge"))


def local_event_slice(num_events: int) -> Tuple[int, int]:
    """[start, end) of the event batch this host should load/feed."""
    p = max(jax.process_count(), 1)
    i = jax.process_index()
    per = (num_events + p - 1) // p
    return i * per, min((i + 1) * per, num_events)


def scaling_report(graphs: Sequence, cfg) -> dict:
    """Weak-scaling measurement on the available devices: per-event
    wall-clock for a batch of B events on 1 device vs B devices, each
    timed to block_until_ready after a compiling warm-up."""
    import time

    from gnn_track_finding.models import pipeline
    from gnn_track_finding.parallel import mesh as pmesh

    b = len(graphs)
    # single device, sequential
    f1 = jax.jit(lambda g: pipeline.full_pipeline(g, cfg)[1].sum())
    seq_sum = sum(int(f1(g)) for g in graphs)     # also warms the compile
    t0 = time.time()
    jax.block_until_ready([f1(g) for g in graphs])
    t_seq = time.time() - t0

    # batched over the mesh
    m = pmesh.make_mesh(shape=(min(b, len(jax.devices())), 1))
    batch = pmesh.stack_events(graphs)
    batch = pmesh.shard_batched_graph(batch, m)
    shardings = pmesh.batched_graph_sharding(batch, m)
    fb = jax.jit(lambda gb: jax.vmap(
        lambda g: pipeline.full_pipeline(g, cfg)[1].sum())(gb).sum(),
        in_shardings=(shardings,))
    par_sum = int(fb(batch))
    t0 = time.time()
    jax.block_until_ready(fb(batch))
    t_par = time.time() - t0

    eff = t_seq / (t_par * m.shape["data"])
    return {"events": b, "devices": m.shape["data"],
            "sequential_s": t_seq, "parallel_s": t_par,
            "scaling_efficiency": eff,
            "sequential_checksum": seq_sum, "parallel_checksum": par_sum}
