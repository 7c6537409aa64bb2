"""Device mesh + sharding for multi-chip execution.

The reference is single-process CPU Python with no parallelism of any kind
(SURVEY.md section 2.3).  The scale-out model here:

  * axis "data"  — event-batch data parallelism: a pileup batch of padded
    events stacked on a leading axis, one shard per mesh column group;
  * axis "edge"  — intra-event sharding of the padded node/edge arrays (the
    sequence-parallel analog: the reference's scale dimension is edge
    count, SURVEY.md section 5).  Gathers of node state across edge shards
    (xyzr[src], merged[src]) and per-node segment reductions become XLA
    collectives between the devices (NVLink on one host), inserted
    automatically from the shardings.

All pipeline stages are pure jitted transforms, so multi-chip execution is
jit(full batched step, in_shardings=...) — no communication code changes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gnn_track_finding.graph.state import GraphState


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if shape is None:
        data = 2 if n % 2 == 0 and n > 1 else 1
        shape = (data, n // data)
    need = shape[0] * shape[1]
    assert need <= n, (shape, n)
    mesh_devices = np.asarray(devices[:need]).reshape(shape)
    return Mesh(mesh_devices, ("data", "edge"))


def batched_graph_sharding(g: GraphState, mesh: Mesh) -> GraphState:
    """Shardings for a GraphState with a leading event-batch axis.

    Batch axis -> "data"; the node/edge array axis -> "edge"; per-node
    tables shard with their node axis.
    """
    def spec(x):
        if x.ndim >= 2:
            return NamedSharding(mesh, P("data", "edge"))
        return NamedSharding(mesh, P("data"))
    return jax.tree.map(spec, g)


def shard_batched_graph(g: GraphState, mesh: Mesh) -> GraphState:
    shardings = batched_graph_sharding(g, mesh)
    return jax.tree.map(jax.device_put, g, shardings)


def stack_events(graphs) -> GraphState:
    """Stack same-shape padded events along a leading batch axis."""
    g0 = graphs[0]
    import jax.numpy as jnp
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *graphs)
    return stacked.replace(n_nodes=g0.n_nodes, n_edges=g0.n_edges,
                           max_degree=g0.max_degree, n_layers=g0.n_layers)


def run_batched(graphs, cfg, mesh: Optional[Mesh] = None):
    """Run the full pipeline over a pileup batch of events, sharded over
    the device mesh (event batch -> "data", arrays -> "edge").

    Returns (final stacked GraphState, accepted (B, I, C), cand_nodes
    (B, I, C, H)) — the data-parallel production entry point; per-event
    results are bit-identical to single-device runs
    (tests/test_parallel.py).
    """
    from gnn_track_finding.models import pipeline

    mesh = mesh or make_mesh()
    batch = stack_events(graphs)
    batch = shard_batched_graph(batch, mesh)
    shardings = batched_graph_sharding(batch, mesh)

    def step(graph):
        return jax.vmap(lambda gg: pipeline.full_pipeline(gg, cfg))(graph)

    step_jit = jax.jit(step, in_shardings=(shardings,))
    return step_jit(batch)
