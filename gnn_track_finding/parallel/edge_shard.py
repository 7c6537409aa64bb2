"""Explicit edge-partitioned message passing via shard_map.

The scale-out axis of this workload is the directed-edge count (SURVEY.md
section 5: the sequence-parallel analog).  `parallel/mesh.py` covers the
event-batch "data" axis; this module partitions ONE event's edge arrays
across the "edge" mesh axis with a designed communication pattern instead
of XLA auto-SPMD:

  * edge arrays (seed/updated states, activation, endpoints) are split
    into contiguous blocks, one per device — pairs stay intact because
    every edge is stored adjacent to its reverse (build.py:94-99) and
    shard sizes are even;
  * node arrays and the fixed-K per-node tables are REPLICATED: node
    state is the boundary data every shard needs (the gather side of the
    reference's scatter at extrapolate_merged_states.py:441-447), and at
    ~100 B/node it is far cheaper to replicate than the edge state is to
    shard;
  * every per-node aggregate (segment sums for priors/reweight/degrees,
    the one-writer-per-slot table scatters) computes a LOCAL partial and
    combines with ONE explicit psum over the edge axis
    (ops/collect.allsum/allor) — the boundary-node exchange.

Per extrapolation stage the collective traffic is fixed and independent
of E: two (N, K) table psums + one (N,) psum per reweight, one (N, K)
bool-table psum in message passing, one (N·L,) psum per prior pass and
one (N,) degree psum — ~6 MB at full-event N with K=64, vs the ~44 MB of
per-shard edge state it would take to replicate the edge arrays.

Auto-SPMD (jit + NamedSharding on the edge axis, parallel/mesh.py) is the
fallback the dryrun exercises; `tools/profile_edge_shard.py` counts the
collectives both lowerings emit, and tests/test_edge_shard.py asserts the
shard_map path matches the single-device stage.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gnn_track_finding.graph.state import (GraphState, is_static,
                                              pytree_dataclass, static_field)


def _shard_map(f, mesh, in_specs, out_specs):
    return jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)

# Directed-edge arrays (leading axis E).  Everything else — node arrays,
# (N, K) tables, static caches — is replicated.  Field NAMES (not shapes)
# decide: padded N and E can coincide.
EDGE_FIELDS = frozenset({
    "edge_mask", "src", "dst", "active",
    "seed_sv", "seed_cov", "seed_joint", "seed_joint_cov",
    "seed_prior", "seed_weight",
    "has_updated", "upd_sv", "upd_cov", "upd_joint", "upd_joint_cov",
    "upd_prior", "upd_weight", "upd_likelihood", "upd_xyzr",
    "slot_in", "slot_out", "e_xyzr", "e_src_layer", "mirror",
    "mirror_src",
})


def graph_pspecs(g: GraphState, axis: str = "edge") -> GraphState:
    """A GraphState-shaped pytree of PartitionSpecs: edge arrays split on
    `axis`, node arrays and tables replicated."""
    kwargs = {}
    for f in dataclasses.fields(GraphState):
        if is_static(f):
            kwargs[f.name] = getattr(g, f.name)
        elif f.name in EDGE_FIELDS:
            kwargs[f.name] = P(axis)
        else:
            kwargs[f.name] = P()
    return GraphState(**kwargs)


def graph_shardings(g: GraphState, mesh: Mesh, axis: str = "edge"
                    ) -> GraphState:
    specs = graph_pspecs(g, axis)
    return jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                        is_leaf=lambda x: isinstance(x, P))


def shard_graph(g: GraphState, mesh: Mesh, axis: str = "edge") -> GraphState:
    """Place an event on the mesh under the edge partition."""
    n_shards = mesh.shape[axis]
    assert g.num_padded_edges % (2 * n_shards) == 0, (
        "edge shards must be even-sized so reverse-edge pairs stay local",
        g.num_padded_edges, n_shards)
    return jax.tree.map(jax.device_put, g, graph_shardings(g, mesh, axis))


@pytree_dataclass
class OwnerRouting:
    """Static routing of per-edge scatter VALUES to their head-node's
    owner shard (the all_to_all refinement of the table exchange).

    Node ownership is INTERLEAVED (owner(i) = i % D, owner-local row
    i // D): edge files list edges in roughly node-id order, so a
    contiguous edge block's heads cluster in id space — interleaving
    keeps the (sender, owner) buckets balanced where contiguous
    ownership would skew them onto one shard.

    All arrays are layout-static (they depend only on dst/slot_in and D,
    never on masks or weights), so they are built once per mesh on the
    host.  owner/pos/own_idx shard with the edge axis; recv_row/recv_slot
    replicate.
    """
    n_shards: int = static_field()
    bucket: int = static_field()   # padded bucket capacity
    owner: jax.Array         # (E,) int32 owner shard of dst, -1 padding
    pos: jax.Array           # (E,) int32 position within the send bucket
    own_idx: jax.Array       # (E,) int32 row of dst in the all_gathered
    #                          owner-major result table: (dst%D)*rows + dst//D
    recv_row: jax.Array      # (D, D, B) int32 owner-local node row, -1 pad
    recv_slot: jax.Array     # (D, D, B) int32 slot_in of the edge


def build_owner_routing(g: GraphState, n_shards: int) -> OwnerRouting:
    """Host-side construction of the static value-routing tables."""
    import numpy as np
    import jax.numpy as jnp

    e_pad = g.num_padded_edges
    n_pad = g.num_padded_nodes
    assert e_pad % n_shards == 0 and n_pad % n_shards == 0, (e_pad, n_pad)
    e_loc = e_pad // n_shards
    rows = n_pad // n_shards

    dst = np.asarray(g.dst).astype(np.int64)
    slot = np.asarray(g.slot_in).astype(np.int64)
    mask = np.asarray(g.edge_mask)

    sender = np.arange(e_pad) // e_loc
    owner = np.where(mask, dst % n_shards, -1)

    # bucket positions: rank of each edge within its (sender, owner) pair
    key = sender * n_shards + np.where(mask, owner, 0)
    key = np.where(mask, key, np.int64(n_shards * n_shards))
    order = np.argsort(key, kind="stable")
    sk = key[order]
    start = np.zeros(e_pad, np.int64)
    change = np.flatnonzero(np.concatenate([[True], sk[1:] != sk[:-1]]))
    start[change] = change
    np.maximum.accumulate(start, out=start)
    pos_sorted = np.arange(e_pad) - start
    pos = np.empty(e_pad, np.int64)
    pos[order] = pos_sorted
    pos = np.where(mask, pos, -1)

    counts = np.bincount(key[mask], minlength=n_shards * n_shards)
    b = int(counts.max()) if counts.size else 1
    b = max(128, -(-b // 128) * 128)      # lane-aligned capacity

    recv_row = np.full((n_shards, n_shards, b), -1, np.int32)
    recv_slot = np.zeros((n_shards, n_shards, b), np.int32)
    m = mask & (pos < b)
    recv_row[owner[m], sender[m], pos[m]] = (dst[m] // n_shards).astype(
        np.int32)
    recv_slot[owner[m], sender[m], pos[m]] = slot[m].astype(np.int32)

    own_idx = ((dst % n_shards) * rows + dst // n_shards).astype(np.int32)
    return OwnerRouting(
        n_shards=n_shards, bucket=b,
        owner=jnp.asarray(np.where(mask, owner, -1).astype(np.int32)),
        pos=jnp.asarray(np.where(mask, pos, -1).astype(np.int32)),
        own_idx=jnp.asarray(own_idx),
        recv_row=jnp.asarray(recv_row), recv_slot=jnp.asarray(recv_slot))


def routing_pspecs(r: OwnerRouting, axis: str = "edge") -> OwnerRouting:
    return OwnerRouting(
        n_shards=r.n_shards, bucket=r.bucket,
        owner=P(axis), pos=P(axis), own_idx=P(axis),
        recv_row=P(), recv_slot=P())


def extrapolation_stage_sharded(cfg, mesh: Mesh, axis: str = "edge",
                                routing: Optional[OwnerRouting] = None):
    """Jitted edge-partitioned extrapolation stage: shard_map over `axis`
    with the explicit collectives inside (ops threading axis_name and the
    owner routing)."""
    from gnn_track_finding.models import pipeline

    def run(g: GraphState, r: Optional[OwnerRouting]) -> GraphState:
        specs = graph_pspecs(g, axis)
        if r is None:
            fn = _shard_map(
                lambda gg: pipeline.extrapolation_stage(
                    gg, cfg, axis_name=axis),
                mesh, in_specs=(specs,), out_specs=specs)
            return fn(g)
        fn = _shard_map(
            lambda gg, rr: pipeline.extrapolation_stage(
                gg, cfg, axis_name=axis, routing=rr),
            mesh, in_specs=(specs, routing_pspecs(r, axis)),
            out_specs=specs)
        return fn(g, r)

    if routing is None:
        return jax.jit(lambda g: run(g, None))
    return jax.jit(lambda g: run(g, routing))


def iteration_sharded(cfg, mesh: Mesh, i: int, routing: OwnerRouting,
                      axis: str = "edge"):
    """Jitted edge-partitioned FULL iteration (stage + extraction +
    metadata pruning) — the reference's unit of work
    (run_gnn_trackml_mod.sh:71-148) under the designed edge partition:
    clustering via the OwnerRouting all_to_all
    (ops/clustering._cluster_sharded), extrapolation via the round-3
    owner exchange, device CCA via per-round (N,) pmin hook combines
    (graph/cca.connected_components_gated), prior/reweight/metadata via
    the owner exchange.  The ExtractionResult is replicated (node/
    candidate-space outputs every shard computes identically)."""
    from gnn_track_finding.models import pipeline
    from gnn_track_finding.ops.extract import ExtractionResult

    def run(g: GraphState, r: OwnerRouting):
        specs = graph_pspecs(g, axis)
        res_specs = ExtractionResult(*([P()] * len(ExtractionResult._fields)))
        fn = _shard_map(
            lambda gg, rr: pipeline.iteration(gg, cfg, i, axis_name=axis,
                                              routing=rr),
            mesh, in_specs=(specs, routing_pspecs(r, axis)),
            out_specs=(specs, res_specs))
        return fn(g, r)

    return jax.jit(lambda g: run(g, routing))


def schedule_sharded(cfg, mesh: Mesh, routing: OwnerRouting,
                     axis: str = "edge"):
    """The whole multi-iteration schedule edge-partitioned in ONE jit
    (the sharded analog of pipeline.full_pipeline)."""
    from gnn_track_finding.models import pipeline
    from gnn_track_finding.ops.extract import ExtractionResult
    import jax.numpy as jnp

    def run(g: GraphState, r: OwnerRouting):
        specs = graph_pspecs(g, axis)

        def body(gg, rr):
            gg = pipeline.prepare(gg, cfg, axis_name=axis)
            accepted = []
            for i in range(1, cfg.num_iterations + 1):
                gg, res = pipeline.iteration(gg, cfg, i, axis_name=axis,
                                             routing=rr)
                accepted.append(res.accepted)
            return gg, jnp.stack(accepted)

        fn = _shard_map(body, mesh,
                        in_specs=(specs, routing_pspecs(r, axis)),
                        out_specs=(specs, P()))
        return fn(g, r)

    return jax.jit(lambda g: run(g, routing))


def edge_mesh(n: Optional[int] = None, devices=None) -> Mesh:
    """A 1-D ("edge",) mesh over the first n devices."""
    import numpy as np
    devices = devices if devices is not None else jax.devices()
    n = n or len(devices)
    return Mesh(np.asarray(devices[:n]), ("edge",))
