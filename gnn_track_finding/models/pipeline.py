"""The full iterative track-finding pipeline — the flagship "model".

The reference orchestrates its stages as separate CLI processes passing
pickled graphs through the filesystem on a fixed schedule
(run_gnn_trackml_mod.sh:71-148):

  iteration 1        : clustering on seed states (chi2=1.0, KL=2.0)
  even iterations    : extrapolation message passing (chi2 cut c)
  odd iterations > 1 : clustering on updated states (chi2=1000, KL=100)
  after every iter   : candidate extraction (accumulating candidates)
  after even iters   : state-metadata pruning

Here each iteration is ONE jitted transform of the device-resident
GraphState; the host driver only sequences them and collects extraction
results.  `full_pipeline` additionally fuses the whole schedule into a
single jittable program (used by benchmarks and the multi-chip dry run).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import List, Tuple

import jax
import numpy as np

from gnn_track_finding.config import PipelineConfig
from gnn_track_finding.graph.state import GraphState
from gnn_track_finding.ops import (clustering, extract, extrapolate,
                                       metadata, priors, seeding)


def prepare(g: GraphState, cfg: PipelineConfig, axis_name=None
            ) -> GraphState:
    """Event-conversion tail: seed states, activation, priors, weights,
    degrees (event_conversion.py:92-101)."""
    g = seeding.seed_track_states(g, cfg, axis_name=axis_name)
    g = priors.initialize_edge_activation(g)
    g = priors.compute_prior_probabilities(g, use_updated=False,
                                           axis_name=axis_name)
    g = priors.compute_mixture_weights(g, use_updated=False,
                                       axis_name=axis_name)
    g = priors.update_degrees(g, axis_name=axis_name)
    return g


def cluster_stage(g: GraphState, cfg: PipelineConfig,
                  use_updated: bool, kl_thresholds=None,
                  axis_name=None, routing=None) -> GraphState:
    """Clustering iteration incl. the weight/prior recompute + degree update
    (clustering.py:323-327,372-373).  kl_thresholds: optional per-node KL
    acceptance thresholds from the calibration LUT (calib/lut.py).

    axis_name/routing: edge-partitioned execution — the clustering core
    runs node-owner-sharded via the OwnerRouting all_to_all
    (ops/clustering._cluster_sharded) and the weight/prior/degree
    segment ops combine across shards."""
    g = clustering.cluster(g, cfg, use_updated, kl_thresholds,
                           axis_name=axis_name, routing=routing)
    g = priors.update_degrees(g, axis_name=axis_name)
    g = priors.compute_mixture_weights(g, use_updated, axis_name=axis_name)
    g = priors.compute_prior_probabilities(g, use_updated,
                                           axis_name=axis_name)
    return g


def extrapolation_stage(g: GraphState, cfg: PipelineConfig,
                        axis_name=None, routing=None) -> GraphState:
    """Extrapolation iteration incl. double prior/reweight + degrees
    (extrapolate_merged_states.py:554-566).

    axis_name: mesh axis of a shard_map edge partition
    (parallel/edge_shard.py); per-node aggregates then combine across
    edge shards with explicit collectives.  routing: optional
    edge_shard.OwnerRouting enabling the node-owner all_to_all exchange
    in the prior/reweight passes."""
    g = extrapolate.message_passing(g, cfg, axis_name=axis_name)
    if axis_name is None:
        # single-device: the whole prior/reweight/degree tail runs
        # table-resident in one scatter/gather cycle (priors.reweight_stage)
        return priors.reweight_stage(g, cfg, n_passes=2)
    g = priors.prior_reweight(g, cfg, axis_name=axis_name, routing=routing)
    g = priors.prior_reweight(g, cfg, axis_name=axis_name, routing=routing)
    g = priors.update_degrees(g, axis_name=axis_name)
    return g


def stage_step(g: GraphState, cfg: PipelineConfig, i: int,
               kl_thresholds=None, axis_name=None, routing=None
               ) -> GraphState:
    """The pre-extraction stage of iteration i (schedule in module doc)."""
    if i == 1:
        return cluster_stage(g, cfg, use_updated=False,
                             kl_thresholds=kl_thresholds,
                             axis_name=axis_name, routing=routing)
    if i % 2 == 0:
        return extrapolation_stage(g, cfg, axis_name=axis_name,
                                   routing=routing)
    return cluster_stage(g, cfg, use_updated=True,
                         kl_thresholds=kl_thresholds,
                         axis_name=axis_name, routing=routing)


def extract_only(g: GraphState, cfg: PipelineConfig, labels=None,
                 axis_name=None
                 ) -> Tuple[GraphState, extract.ExtractionResult]:
    """Extraction + candidate-node removal (no metadata pruning)."""
    res = extract.extract_candidates(g, cfg, labels, axis_name=axis_name)
    g = extract.apply_extraction(g, res, cfg)
    return g, res


def metadata_step(g: GraphState, cfg: PipelineConfig,
                  axis_name=None, routing=None) -> GraphState:
    if axis_name is None:
        return metadata.remove_state_metadata(g, cfg)
    # sharded: same semantics through the collective-aware passes
    # (remove_state_metadata's table-resident fusion is single-device)
    g = g.replace(has_updated=g.has_updated & g.edge_mask)
    g = priors.compute_prior_probabilities(g, use_updated=False,
                                           axis_name=axis_name)
    g = priors.prior_reweight(g, cfg, axis_name=axis_name, routing=routing)
    g = priors.update_degrees(g, axis_name=axis_name)
    return g


def extract_step(g: GraphState, cfg: PipelineConfig, i: int, labels=None,
                 axis_name=None, routing=None
                 ) -> Tuple[GraphState, extract.ExtractionResult]:
    """Extraction + removal + (even iterations) metadata pruning."""
    g, res = extract_only(g, cfg, labels, axis_name=axis_name)
    if i % 2 == 0:
        g = metadata_step(g, cfg, axis_name=axis_name, routing=routing)
    return g, res


def iteration(g: GraphState, cfg: PipelineConfig, i: int, kl_thresholds=None,
              axis_name=None, routing=None
              ) -> Tuple[GraphState, extract.ExtractionResult]:
    """One full iteration: stage + extraction + metadata pruning.

    axis_name/routing: run the WHOLE iteration edge-partitioned — the
    reference's unit of work (run_gnn_trackml_mod.sh:71-148) — with the
    designed exchanges in every stage (clustering owner-routing, CCA
    pmin hooks, prior/reweight owner exchange)."""
    g = stage_step(g, cfg, i, kl_thresholds, axis_name=axis_name,
                   routing=routing)
    return extract_step(g, cfg, i, axis_name=axis_name, routing=routing)


def reset_reactivate(g: GraphState, cfg: PipelineConfig) -> GraphState:
    """Brute-force reset of a remaining network (clustering.py:126-146,
    '-r' CLI flag): drop merged and updated states, reactivate every
    surviving edge, re-seed states and recompute priors/weights."""
    import jax.numpy as jnp
    g = g.replace(
        has_merged=jnp.zeros_like(g.has_merged),
        has_updated=jnp.zeros_like(g.has_updated),
    )
    return prepare(g, cfg)


@dataclasses.dataclass
class Candidate:
    nodes: np.ndarray      # original-graph node indices
    iteration: int
    pval_xy: float
    pval_zr: float


@dataclasses.dataclass
class PipelineResult:
    graph: GraphState
    candidates: List[Candidate]
    per_iteration: List[extract.ExtractionResult]


_iteration_jit = jax.jit(iteration, static_argnums=(1, 2))
_prepare_jit = jax.jit(prepare, static_argnums=1)
_stage_jit = jax.jit(stage_step, static_argnums=(1, 2))
_extract_jit = jax.jit(extract_step, static_argnums=(1, 2))
_extract_only_jit = jax.jit(extract_only, static_argnums=1)
_metadata_jit = jax.jit(metadata_step, static_argnums=1)


def _host_cca_labels(g: GraphState):
    """CCA labels via the native union-find (one linear host pass) when the
    C++ loader is built; None -> the jitted path falls back to device CCA."""
    from gnn_track_finding.data import native_loader
    if not native_loader.available():
        return None
    import jax.numpy as jnp
    ok = np.asarray(g.edge_mask & g.active)
    src = np.asarray(g.src)
    dst = np.asarray(g.dst)
    labels = native_loader.connected_components_native(
        src, dst, ok, g.num_padded_nodes)
    return jnp.asarray(labels)


def _apply_gnn_mutations(g: GraphState, mutations,
                         in_tab: np.ndarray, slot_out: np.ndarray,
                         src: np.ndarray) -> GraphState:
    """Apply extraction-leak coordinate mutations (graph/nxorder.py) to the
    live GNN coordinate view and the out-table head-coordinate cache."""
    import jax.numpy as jnp
    last = {}
    for node, coords in mutations:      # later mutations win (in-place ref)
        last[node] = coords
    nodes = np.fromiter(last.keys(), np.int32, len(last))
    coords = np.array([last[n] for n in nodes], np.float64)
    # out_head_xyzr[src[e], slot_out[e]] holds gnn_xyzr[dst[e]]: refresh the
    # slots of every in-edge of each mutated node
    rows, slots, vals = [], [], []
    for node, c in last.items():
        for ei in in_tab[node]:
            if ei >= 0:
                rows.append(int(src[ei]))
                slots.append(int(slot_out[ei]))
                vals.append(c)
    new_gnn = g.gnn_xyzr.at[nodes].set(jnp.asarray(coords, g.dtype))
    out_head = g.out_head_xyzr
    if rows:
        out_head = out_head.at[np.array(rows), np.array(slots)].set(
            jnp.asarray(np.array(vals, np.float64), g.dtype))
    return g.replace(gnn_xyzr=new_gnn, out_head_xyzr=out_head)


def run_pipeline(g: GraphState, cfg: PipelineConfig,
                 kl_thresholds=None, host_cca: bool = True,
                 tracker=None) -> PipelineResult:
    """Host driver: sequence jitted iterations, collect candidates.

    tracker: optional graph/nxorder.RefOrderTracker (from HostEvent).  In
    bug_compat mode it replays each extraction's close-proximity merges and
    applies the reference's GNN-coordinate leak
    (extract_track_candidates.py:113-116) between extraction and the next
    stage; without it (or in clean mode) coordinates stay immutable.
    """
    true_counts = (g.n_nodes, g.n_edges)
    g = _prepare_jit(_normalize_static(g), cfg)   # see _normalize_static
    candidates: List[Candidate] = []
    per_iter = []
    emulate_leak = tracker is not None and cfg.bug_compat
    if emulate_leak:
        vivl_np = np.asarray(g.vivl)
        xyzr_np = np.asarray(g.xyzr, np.float64)
        in_tab_np = np.asarray(g.in_edges)
        slot_out_np = np.asarray(g.slot_out)
        src_np = np.asarray(g.src)
    for i in range(1, cfg.num_iterations + 1):
        g = _stage_jit(g, cfg, i, kl_thresholds)
        if emulate_leak:
            active_in = np.asarray(g.edge_mask & g.active)
        labels = _host_cca_labels(g) if host_cca else None
        g, res = _extract_only_jit(g, cfg, labels)
        per_iter.append(res)
        # pull only the accepted-compacted head, not the full (C, H)
        # candidate matrix
        n_acc = int(res.acc_count)
        acc_sets = []
        if n_acc:
            mat = np.asarray(res.acc_nodes[:n_acc])
            pv = np.asarray(res.acc_pvals[:n_acc])
            for c in range(n_acc):
                nodes = mat[c]
                nodes = nodes[nodes >= 0]
                acc_sets.append(set(int(x) for x in nodes))
                candidates.append(Candidate(nodes=nodes,
                                            iteration=i,
                                            pval_xy=float(pv[c, 0]),
                                            pval_zr=float(pv[c, 1])))
        if emulate_leak:
            muts = tracker.extraction_merges(
                active_in, vivl_np, xyzr_np, acc_sets,
                cfg.min_track_hits, cfg.node_merge_distance)
            if muts:
                g = _apply_gnn_mutations(g, muts, in_tab_np, slot_out_np,
                                         src_np)
        if i % 2 == 0:
            g = _metadata_jit(g, cfg)
    g = g.replace(n_nodes=true_counts[0], n_edges=true_counts[1])
    return PipelineResult(graph=g, candidates=candidates,
                          per_iteration=per_iter)


@partial(jax.jit, static_argnums=1)
def full_pipeline_results(g: GraphState, cfg: PipelineConfig):
    """The whole schedule as ONE jitted program, returning per-iteration
    accepted-compacted candidate heads (count, nodes, pvals).

    This is the production streaming entry point: one dispatch per event
    (no per-stage host round trips, no host CCA pulls), device CCA via
    adaptive FastSV (graph/cca.py), candidates read back as exactly
    acc_count rows.  Results are identical to run_pipeline without a
    tracker (the device FastSV labels equal the host union-find's
    min-node labels; asserted in tests/test_pipeline.py)."""
    import jax.numpy as jnp
    g = prepare(g, cfg)
    counts, nodes, pvals = [], [], []
    for i in range(1, cfg.num_iterations + 1):
        g, res = iteration(g, cfg, i)
        counts.append(res.acc_count)
        # static-cap head slice: the host only ever reads acc_count rows,
        # and slicing on device with a STATIC cap keeps the readback one
        # compiled program regardless of the per-event count (a dynamic
        # [:n] slice would recompile per distinct count)
        cap = min(ACC_PULL_CAP, res.acc_nodes.shape[0])
        nodes.append(res.acc_nodes[:cap])
        pvals.append(res.acc_pvals[:cap])
    return g, jnp.stack(counts), jnp.stack(nodes), jnp.stack(pvals)


# Rows of the accepted-compacted head pulled to host per iteration by the
# fast driver.  The densest observed extraction accepts 1,056 candidates
# (full event, iteration 1); if an event ever exceeds the cap the driver
# falls back to the stage-by-stage path, which pulls exact counts.
ACC_PULL_CAP = 2048


@partial(jax.jit, static_argnums=1)
def full_pipeline_packed(g: GraphState, cfg: PipelineConfig):
    """full_pipeline_results with the ENTIRE host readback packed into ONE
    flat uint32 buffer on device: a [cap, track_len, narrow] header, the
    per-iteration accepted counts, the node lists (uint16 pairs when every
    node id fits — n_pad <= 0xffff, sentinel 0xffff for padding; int32
    bitcast otherwise) and the f32 p-values bitcast in: one ~0.45 MB
    device->host fetch per event instead of three totalling ~0.84 MB.
    Returns (final_graph, packed); the graph stays resident on device."""
    g2, counts, nodes, pvals = full_pipeline_results(g, cfg)
    narrow = g.xyzr.shape[0] <= 0xFFFF            # ids <= n_pad-1 < sentinel
    return g2, pack_results(counts, nodes, pvals, narrow)


def pack_results(counts, nodes, pvals, narrow: bool):
    """Pack (counts (I,), nodes (I,cap,L) int32/-1 pad, pvals (I,cap,2))
    into one flat uint32 buffer (jittable; exact inverse unpack_results)."""
    import jax.numpy as jnp
    n_it, cap, track_len = nodes.shape            # static under jit
    if narrow:
        # low 16 bits via bitcast+mask (well-defined for the -1 padding:
        # 0xffff sentinel; valid ids < n_pad <= 0xffff convert exactly)
        nd = (jax.lax.bitcast_convert_type(nodes.reshape(-1), jnp.uint32)
              & 0xFFFF).astype(jnp.uint16)
        if nd.shape[0] % 2:
            nd = jnp.concatenate([nd, jnp.full((1,), 0xFFFF, jnp.uint16)])
        nd32 = jax.lax.bitcast_convert_type(nd.reshape(-1, 2), jnp.uint32)
    else:
        nd32 = jax.lax.bitcast_convert_type(
            nodes.reshape(-1).astype(jnp.int32), jnp.uint32)
    pv_wide = pvals.dtype == jnp.float64
    if pv_wide:     # f64 bitcast -> (..., 2) uint32; raw little-endian bytes
        pv32 = jax.lax.bitcast_convert_type(
            pvals.reshape(-1), jnp.uint32).reshape(-1)
    else:
        pv32 = jax.lax.bitcast_convert_type(
            pvals.reshape(-1).astype(jnp.float32), jnp.uint32)
    header = jnp.array([cap, track_len, int(narrow), int(pv_wide)],
                       jnp.uint32)
    return jnp.concatenate([header, counts.astype(jnp.uint32), nd32, pv32])


def unpack_results(buf: np.ndarray, n_it: int):
    """Host-side inverse of pack_results.

    -> (counts (I,), nodes (I,cap,L) int32, pvals (I,cap,2), sentinel) —
    node entries equal to `sentinel` are padding."""
    cap, track_len, narrow, pv_wide = (int(buf[0]), int(buf[1]),
                                       bool(buf[2]), bool(buf[3]))
    counts = buf[4:4 + n_it].astype(np.int64)
    n_nd = n_it * cap * track_len
    off = 4 + n_it
    if narrow:
        nd32 = buf[off:off + (n_nd + 1) // 2]
        nodes = nd32.view(np.uint16)[:n_nd].astype(np.int32)
        sentinel = 0xFFFF
        off += (n_nd + 1) // 2
    else:
        nodes = np.ascontiguousarray(buf[off:off + n_nd]).view(np.int32)
        sentinel = -1
        off += n_nd
    nodes = nodes.reshape(n_it, cap, track_len)
    pv_dtype = np.float64 if pv_wide else np.float32
    pvals = np.ascontiguousarray(buf[off:]).view(pv_dtype) \
        .reshape(n_it, cap, 2)
    return counts, nodes, pvals, sentinel


def _unpack_packed(g_in: GraphState, g_out, packed,
                   cfg: PipelineConfig) -> PipelineResult:
    """Pull the single packed buffer and rebuild candidates — the exact
    inverse of full_pipeline_packed's layout (header / counts / nodes /
    pvals).  Falls back to the exact-count stage driver if any
    iteration's accepted count exceeded the pull cap (never observed;
    see ACC_PULL_CAP)."""
    n_it = cfg.num_iterations
    buf = np.asarray(jax.device_get(packed))
    counts, nodes, pvals, sentinel = unpack_results(buf, n_it)
    if counts.max(initial=0) > nodes.shape[1]:
        return run_pipeline(g_in, cfg)
    candidates: List[Candidate] = []
    for it in range(n_it):
        for c in range(int(counts[it])):
            nn = nodes[it, c]
            nn = nn[nn != sentinel]
            candidates.append(Candidate(nodes=nn, iteration=it + 1,
                                        pval_xy=float(pvals[it, c, 0]),
                                        pval_zr=float(pvals[it, c, 1])))
    return PipelineResult(graph=g_out, candidates=candidates,
                          per_iteration=[])


def _unpack_results(g_in: GraphState, res, cfg: PipelineConfig
                    ) -> PipelineResult:
    """Pull + unpack a full_pipeline_results return into candidates."""
    g, counts, nodes, pvals = res
    nodes, pvals, counts_np = jax.device_get((nodes, pvals, np.asarray(counts)))
    if int(counts_np.max(initial=0)) > nodes.shape[1]:
        # accepted rows exceed the pull cap (never observed; see
        # ACC_PULL_CAP) — rerun via the exact-count driver
        return run_pipeline(g_in, cfg)
    candidates: List[Candidate] = []
    for it in range(cfg.num_iterations):
        n_acc = int(counts_np[it])
        for c in range(n_acc):
            nn = nodes[it][c]
            nn = nn[nn >= 0]
            candidates.append(Candidate(nodes=nn, iteration=it + 1,
                                        pval_xy=float(pvals[it][c, 0]),
                                        pval_zr=float(pvals[it][c, 1])))
    return PipelineResult(graph=g, candidates=candidates, per_iteration=[])


def _normalize_static(g: GraphState) -> GraphState:
    """Zero the n_nodes/n_edges aux fields for jit dispatch.

    They are host-side metadata that NO jitted stage reads (the true
    counts live in node_mask/edge_mask — graph/state.py), but as
    hashable aux data they key the jit cache: without this, every
    distinct true event size would compile its own copy of the whole
    schedule (~26 s remote compile at full-event shapes) even when the
    padded bucket shapes are identical.  Normalised here so a production
    stream of DISTINCT events compiles once per bucket, not per event
    (pinned by tests/test_pipeline.py::test_distinct_counts_share_compile)."""
    return g.replace(n_nodes=0, n_edges=0)


def run_pipeline_fast(g: GraphState, cfg: PipelineConfig) -> PipelineResult:
    """Fast streaming driver: full_pipeline_packed (one dispatch, one
    packed readback buffer) + host candidate unpack.  Use for
    throughput; run_pipeline for the parity/driver path (host CCA,
    extraction-leak emulation)."""
    g_out, packed = full_pipeline_packed(_normalize_static(g), cfg)
    g_out = g_out.replace(n_nodes=g.n_nodes, n_edges=g.n_edges)
    return _unpack_packed(g, g_out, packed, cfg)


def stream_pipeline(graphs, cfg: PipelineConfig, depth: int = 1):
    """Software-pipelined multi-event streaming: dispatch event i+1's
    fused schedule (async) BEFORE pulling event i's results, so the
    host-side readback + candidate unpack of one event hides under the
    next event's device compute.  With the prefetch loader feeding
    `graphs` (data/prefetch.py), three things overlap per event: ingest
    of i+2, device compute of i+1, readback of i.

    `depth` is the number of dispatched-but-unread events kept in
    flight; >1 queues extra schedules on the device stream so readback
    latency hides under more compute (each queued event holds its own
    GraphState + results on device, ~40 MB/event at full-event f32).

    Yields one PipelineResult per input graph, in order."""
    import collections
    pending: collections.deque = collections.deque()
    for g in graphs:
        g_out, packed = full_pipeline_packed(_normalize_static(g), cfg)
        g_out = g_out.replace(n_nodes=g.n_nodes, n_edges=g.n_edges)
        if len(pending) >= depth:                      # async dispatch above
            yield _unpack_packed(*pending.popleft(), cfg)
        pending.append((g, g_out, packed))
    while pending:
        yield _unpack_packed(*pending.popleft(), cfg)


@partial(jax.jit, static_argnums=1)
def full_pipeline(g: GraphState, cfg: PipelineConfig):
    """The whole schedule as one jitted program.

    Returns the final graph plus per-iteration (accepted, cand_nodes)
    stacked device arrays — the benchmarking / dry-run entry point.
    """
    g = prepare(g, cfg)
    accepted = []
    cand_nodes = []
    for i in range(1, cfg.num_iterations + 1):
        g, res = iteration(g, cfg, i)
        accepted.append(res.accepted)
        cand_nodes.append(res.cand_nodes)
    import jax.numpy as jnp
    return g, jnp.stack(accepted), jnp.stack(cand_nodes)
