"""Edge-partitioned extrapolation: shard_map vs single device.

The edge axis is this workload's sequence-parallel analog (SURVEY.md
section 5); parallel/edge_shard.py partitions one event's directed-edge
arrays over the mesh with explicit psum combines for every per-node
aggregate.  These tests pin (a) numerical agreement with the single-device
stage on the 8-virtual-device CPU mesh, and (b) that the designed
communication pattern actually lowers to all-reduces of node-sized
aggregates — not all-gathers of edge-sized state.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gnn_track_finding.config import PipelineConfig
from gnn_track_finding.graph.build import build_graph_state
from gnn_track_finding.graph.state import is_static
from gnn_track_finding.models import toymc, pipeline
from gnn_track_finding.parallel import edge_shard

CFG = PipelineConfig(node_bucket=64, edge_bucket=256)

needs_mesh = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")


def _staged_graph(num_tracks=20, seed=3):
    ev = toymc.generate_event(num_tracks=num_tracks, seed=seed)
    g, _ = build_graph_state(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs,
                             CFG, dtype=jnp.float64)
    g = pipeline._prepare_jit(g, CFG)
    g = pipeline._stage_jit(g, CFG, 1, None)   # clustering -> merged states
    return g


@needs_mesh
def test_edge_sharded_stage_matches_single_device():
    g = _staged_graph()
    single = jax.jit(pipeline.extrapolation_stage,
                     static_argnums=1)(g, CFG)

    mesh = edge_shard.edge_mesh(8)
    gs = edge_shard.shard_graph(g, mesh)
    sharded = edge_shard.extrapolation_stage_sharded(CFG, mesh)(gs)

    for f in dataclasses.fields(type(g)):
        if is_static(f):
            continue
        a = np.asarray(getattr(single, f.name))
        b = np.asarray(getattr(sharded, f.name))
        if a.dtype == bool or np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            # psum reassociates float segment sums at shard boundaries;
            # everything else is bitwise identical
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-300,
                                       err_msg=f.name)


@needs_mesh
def test_edge_sharded_lowering_uses_node_sized_allreduce_only():
    g = _staged_graph()
    mesh = edge_shard.edge_mesh(8)
    gs = edge_shard.shard_graph(g, mesh)
    txt = (edge_shard.extrapolation_stage_sharded(CFG, mesh)
           .lower(gs).compile().as_text())
    n_allreduce = txt.count("all-reduce-start") or txt.count(" all-reduce(")
    assert n_allreduce >= 1, "expected psum combines in the lowering"
    # the designed exchange is node-sized aggregates only: an all-gather
    # materialising a full edge-sized array would mean the partition
    # degenerated to replication
    e_local = g.num_padded_edges // 8
    for line in txt.splitlines():
        if "all-gather" in line and f"{g.num_padded_edges}]" in line:
            raise AssertionError(f"edge-sized all-gather in lowering: "
                                 f"{line.strip()} (shard={e_local})")


@needs_mesh
def test_edge_sharded_pair_swap_stays_local():
    # reverse-edge weight lookup is a pair swap (build interleaves e, e^1);
    # shard sizes must keep pairs intact
    g = _staged_graph()
    mesh = edge_shard.edge_mesh(8)
    assert g.num_padded_edges % (2 * 8) == 0
    gs = edge_shard.shard_graph(g, mesh)
    out = edge_shard.extrapolation_stage_sharded(CFG, mesh)(gs)
    single = jax.jit(pipeline.extrapolation_stage,
                     static_argnums=1)(g, CFG)
    np.testing.assert_allclose(np.asarray(out.upd_weight),
                               np.asarray(single.upd_weight), rtol=1e-12)


@needs_mesh
def test_owner_routing_stage_matches_single_device():
    """The node-owner all_to_all exchange (edge_shard.OwnerRouting): edge
    payloads route straight to their head's owner shard, per-node results
    all_gather back — numerics must match the single-device stage like
    the dense combine does."""
    g = _staged_graph()
    single = jax.jit(pipeline.extrapolation_stage,
                     static_argnums=1)(g, CFG)

    mesh = edge_shard.edge_mesh(8)
    routing = edge_shard.build_owner_routing(g, 8)
    # routing must cover every real edge exactly once
    owner = np.asarray(routing.owner)
    mask = np.asarray(g.edge_mask)
    assert (owner[mask] >= 0).all() and (owner[~mask] == -1).all()
    assert (np.asarray(routing.pos)[mask] < routing.bucket).all()

    gs = edge_shard.shard_graph(g, mesh)
    sharded = edge_shard.extrapolation_stage_sharded(
        CFG, mesh, routing=routing)(gs)

    for f in dataclasses.fields(type(g)):
        if is_static(f):
            continue
        a = np.asarray(getattr(single, f.name))
        b = np.asarray(getattr(sharded, f.name))
        if a.dtype == bool or np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-300,
                                       err_msg=f.name)


@needs_mesh
def test_owner_routing_lowering_has_all_to_all():
    """The designed exchange must actually lower to an all_to_all plus
    narrow all_gathers — with NO (N, K) f32 table all-reduce left."""
    g = _staged_graph()
    mesh = edge_shard.edge_mesh(8)
    routing = edge_shard.build_owner_routing(g, 8)
    gs = edge_shard.shard_graph(g, mesh)
    txt = (edge_shard.extrapolation_stage_sharded(CFG, mesh, routing=routing)
           .lower(gs).compile().as_text())
    assert "all-to-all" in txt, "owner routing must lower to all-to-all"
    k = g.in_edges.shape[1]
    n = g.num_padded_nodes
    for line in txt.splitlines():
        if "all-reduce" in line and f"[{n},{k}]" in line and (
                "f64[" in line or "f32[" in line):
            raise AssertionError(
                f"(N, K) float table still rides all-reduce: {line.strip()}")


def _fresh_graph(num_tracks=20, seed=3):
    ev = toymc.generate_event(num_tracks=num_tracks, seed=seed)
    g, _ = build_graph_state(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs,
                             CFG, dtype=jnp.float64)
    return pipeline._prepare_jit(g, CFG)


def _assert_graphs_match(single, sharded):
    for f in dataclasses.fields(type(single)):
        if is_static(f):
            continue
        a = np.asarray(getattr(single, f.name))
        b = np.asarray(getattr(sharded, f.name))
        if a.dtype == bool or np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-300,
                                       err_msg=f.name)


@needs_mesh
def test_full_iteration_sharded_matches_single_device():
    """The WHOLE iteration (clustering / extrapolation stage + gated-CCA
    extraction + metadata pruning) runs edge-partitioned with the
    designed exchanges and matches the single-device iteration at every
    step of the 3-iteration schedule — clustering rides the OwnerRouting
    all_to_all (ops/clustering._cluster_sharded), the device CCA combines
    hooks with per-round (N,) pmin."""
    g = _fresh_graph()
    mesh = edge_shard.edge_mesh(8)
    routing = edge_shard.build_owner_routing(g, 8)
    gs = edge_shard.shard_graph(g, mesh)

    for i in (1, 2, 3):
        single, res_s = pipeline._iteration_jit(g, CFG, i)
        it = edge_shard.iteration_sharded(CFG, mesh, i, routing)
        sharded, res_p = it(gs)
        _assert_graphs_match(single, sharded)
        np.testing.assert_array_equal(np.asarray(res_s.accepted),
                                      np.asarray(res_p.accepted))
        np.testing.assert_array_equal(np.asarray(res_s.cand_nodes),
                                      np.asarray(res_p.cand_nodes))
        np.testing.assert_array_equal(np.asarray(res_s.labels),
                                      np.asarray(res_p.labels))
        np.testing.assert_allclose(np.asarray(res_s.pval_xy),
                                   np.asarray(res_p.pval_xy), rtol=1e-12)
        g, gs = single, sharded


@needs_mesh
def test_full_schedule_sharded_matches_full_pipeline():
    g0 = toymc.generate_event(num_tracks=20, seed=5)
    g, _ = build_graph_state(g0.xyzr, g0.vivl, g0.truth, g0.edge_pairs,
                             CFG, dtype=jnp.float64)
    single, acc_s, _ = pipeline.full_pipeline(g, CFG)

    mesh = edge_shard.edge_mesh(8)
    routing = edge_shard.build_owner_routing(g, 8)
    gs = edge_shard.shard_graph(g, mesh)
    sharded, acc_p = edge_shard.schedule_sharded(CFG, mesh, routing)(gs)
    np.testing.assert_array_equal(np.asarray(acc_s), np.asarray(acc_p))
    _assert_graphs_match(single, sharded)


@needs_mesh
def test_full_iteration_sharded_lowering():
    """Lowering pins for the sharded full iteration: the clustering
    exchange lowers to all-to-all; no edge-sized f32/f64 all-gather and
    no (N, K) float-table all-reduce anywhere in the program."""
    g = _fresh_graph()
    mesh = edge_shard.edge_mesh(8)
    routing = edge_shard.build_owner_routing(g, 8)
    gs = edge_shard.shard_graph(g, mesh)
    n = g.num_padded_nodes
    k = g.in_edges.shape[1]
    for i in (1, 2):
        txt = (edge_shard.iteration_sharded(CFG, mesh, i, routing)
               .lower(gs).compile().as_text())
        assert "all-to-all" in txt, f"iteration {i}: no all-to-all"
        for line in txt.splitlines():
            bad_gather = ("all-gather" in line
                          and f"{g.num_padded_edges}]" in line
                          and ("f64[" in line or "f32[" in line))
            bad_reduce = ("all-reduce" in line and f"[{n},{k}]" in line
                          and ("f64[" in line or "f32[" in line))
            if bad_gather or bad_reduce:
                raise AssertionError(
                    f"iteration {i}: oversized collective: {line.strip()}")
