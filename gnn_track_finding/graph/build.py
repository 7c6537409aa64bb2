"""Host-side ingest: raw event arrays -> padded GraphState.

Replaces the reference's pandas/NetworkX construction path
(helper.py:465-545, event_conversion.py:62-101) with array building:
dedup + bidirectional expansion of the undirected edge list
(helper.py:510-518), union-find connected components
(event_conversion.py:84), dense layer/particle re-indexing, fixed-K
in/out-edge tables in CSV insertion order (reproducing NetworkX adjacency
iteration order), and padding to static shape buckets so jitted programs
recompile only across bucket boundaries.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import List, Optional

import numpy as np
import jax
import jax.numpy as jnp

from gnn_track_finding.config import PipelineConfig
from gnn_track_finding.graph.nxorder import RefOrderTracker
from gnn_track_finding.graph.state import GraphState


@dataclasses.dataclass
class HostEvent:
    """Host-only per-event data (evaluation, provenance); never on device."""
    node_ids: np.ndarray            # original node_idx per dense node
    particle_ids: np.ndarray        # original (int64) particle id per dense truth idx
    # node -> hits dissociation (reference 'hit_dissociation', helper.py:474-478)
    hit_ids: Optional[List[np.ndarray]] = None
    hit_particle_ids: Optional[List[np.ndarray]] = None
    module_ids: Optional[List[np.ndarray]] = None
    # reference NetworkX-order replica (graph/nxorder.py) — the driver
    # feeds it each extraction to reproduce the GNN-coordinate leak
    tracker: Optional[object] = None
    # host copy of the set()-order mirror (true-e length) for the event
    # cache: in clean mode the DEVICE mirror is identity (never read —
    # every consumer is bug_compat-gated) and is not transferred, so the
    # cache writer must take the real one from here
    mirror: Optional[np.ndarray] = None


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class UnionFind:
    def __init__(self, n: int):
        self.parent = np.arange(n)

    def find(self, i: int) -> int:
        p = self.parent
        root = i
        while p[root] != root:
            root = p[root]
        while p[i] != root:
            p[i], i = root, p[i]
        return root

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[max(ra, rb)] = min(ra, rb)


def connected_components_host(n: int, pairs: np.ndarray) -> np.ndarray:
    """Union-find CCA over undirected pairs -> min-node-labelled components."""
    uf = UnionFind(n)
    for u, v in pairs:
        uf.union(int(u), int(v))
    return np.array([uf.find(i) for i in range(n)], dtype=np.int32)


@partial(jax.jit, static_argnums=1)
def _device_init(h: dict, k: int) -> dict:
    """All GraphState device arrays from a MINIMAL padded host-array set
    in ONE jitted program (keyed by bucket shapes + dtype, so it compiles
    once per bucket).

    One dispatch instead of ~30 eager ops, ~8 MB transferred instead of
    ~40 for the full event.  On device it reconstructs everything else:

      * src/dst from the undirected pair list (the interleaving is a
        reshape: 2i = u->v, 2i+1 = v->u);
      * node/edge masks from the true counts (iota < n);
      * the fixed-K edge tables from (endpoint, slot) one-writer scatters
        — the exact inverse of the maps the tables define;
      * mirror_src = src[mirror]; the derived gather caches (e_xyzr,
        e_src_layer, out_head_xyzr, in_src_x, in_src_layer);
      * all zero state buffers.

    Every reconstruction is bit-exact vs the old host padding (masked
    fills 0 / -1 match; pinned by tests/test_graph_build.py)."""
    dtype = h["xyzr"].dtype
    n_pad = h["xyzr"].shape[0]
    e_pad = 2 * h["pairs"].shape[0]
    f = lambda *s: jnp.zeros(s, dtype)

    xyzr = h["xyzr"]
    layer = h["layer_idx"].astype(jnp.int32)
    pairs = h["pairs"].astype(jnp.int32)        # may ride as uint16
    truth = (h["truth"].astype(jnp.int32) - 1   # uint16 rides as idx+1
             if h["truth"].dtype == jnp.uint16 else h["truth"])
    src = pairs.reshape(-1)                     # [u0, v0, u1, v1, ...]
    dst = pairs[:, ::-1].reshape(-1)            # [v0, u0, v1, u1, ...]
    node_mask = jnp.arange(n_pad, dtype=jnp.int32) < h["n"]
    edge_mask = jnp.arange(e_pad, dtype=jnp.int32) < h["e"]
    slot_in = h["slot_in"].astype(jnp.int32)
    slot_out = h["slot_out"].astype(jnp.int32)
    e_idx = jnp.arange(e_pad, dtype=jnp.int32)
    # one-writer-per-slot scatters; padded edges routed out of range and
    # dropped
    in_tab = jnp.full((n_pad, k), -1, jnp.int32).at[
        jnp.where(edge_mask, dst, n_pad), slot_in].set(e_idx, mode="drop")
    out_tab = jnp.full((n_pad, k), -1, jnp.int32).at[
        jnp.where(edge_mask, src, n_pad), slot_out].set(e_idx, mode="drop")
    mirror = (h["mirror"] if "mirror" in h
              else jnp.arange(e_pad, dtype=jnp.int32))  # clean: identity

    # Derived caches via EDGE-SIZED one-writer scatters, not (N, K)
    # table-space gathers: the tables hold N*K = ~3.7M slots at the full
    # event but only E = ~344k are real (~91% padding).  Scattering each
    # real edge's value into its (owner, slot) cell touches ~10x fewer
    # elements and is bit-exact: unset cells keep the fill (0 / -1) the
    # gather form's mask produced.
    from gnn_track_finding.ops import gtools
    xyzr_src = xyzr[src]                       # (E,4) full-row gathers
    xyzr_dst = xyzr[dst]
    layer_src = gtools.gather1d(layer, src)
    mirror_src = jnp.where(edge_mask,
                           src if "mirror" not in h
                           else gtools.gather1d(src, mirror), 0)
    e_xyzr = jnp.where(edge_mask[:, None],
                       jnp.concatenate([xyzr_src, xyzr_dst], axis=1), 0)
    e_src_layer = jnp.where(edge_mask, layer_src, 0)
    row_src = jnp.where(edge_mask, src, n_pad)   # padded edges dropped
    row_dst = jnp.where(edge_mask, dst, n_pad)
    out_head = jnp.zeros((n_pad, k, 4), dtype).at[
        row_src, slot_out].set(xyzr_dst, mode="drop")
    in_src_x = jnp.zeros((n_pad, k), dtype).at[
        row_dst, slot_in].set(xyzr_src[:, 0], mode="drop")
    in_src_layer = jnp.full((n_pad, k), -1, jnp.int32).at[
        row_dst, slot_in].set(layer_src, mode="drop")
    return dict(
        node_mask=node_mask,
        xyzr=xyzr,
        gnn_xyzr=xyzr,      # immutable jax array: safe to alias at build
        vivl=h["vivl"].astype(jnp.int32), layer_idx=layer,
        truth=truth, component=h["component"].astype(jnp.int32),
        degree=jnp.zeros(n_pad, jnp.int32),
        has_merged=jnp.zeros(n_pad, bool),
        merged_state=f(n_pad, 3), merged_cov=f(n_pad, 3, 3),
        merged_prior=f(n_pad), grad_stats=f(n_pad, 4),
        edge_mask=edge_mask, src=src, dst=dst,
        active=edge_mask,
        seed_sv=f(e_pad, 3), seed_cov=f(e_pad, 3, 3),
        seed_joint=f(e_pad, 3), seed_joint_cov=f(e_pad, 3, 3),
        seed_prior=f(e_pad), seed_weight=f(e_pad),
        has_updated=jnp.zeros(e_pad, bool),
        upd_sv=f(e_pad, 3), upd_cov=f(e_pad, 3, 3),
        upd_joint=f(e_pad, 3), upd_joint_cov=f(e_pad, 3, 3),
        upd_prior=f(e_pad), upd_weight=f(e_pad), upd_likelihood=f(e_pad),
        upd_xyzr=f(e_pad, 4),
        in_edges=in_tab, out_edges=out_tab,
        slot_in=slot_in, slot_out=slot_out,
        e_xyzr=e_xyzr, e_src_layer=e_src_layer,
        out_head_xyzr=out_head, in_src_x=in_src_x,
        in_src_layer=in_src_layer,
        mirror=mirror, mirror_src=mirror_src,
    )


def compute_mirror(n: int, src: np.ndarray, dst: np.ndarray,
                   orig_of: np.ndarray, orders) -> np.ndarray:
    """Mirror in-edge per directed edge (reference tau-pairing defect,
    helper.py:349-429): for each node, the k-th neighbour in the
    reference's set() iteration order borrows tau from neighbour d-1-k.
    `orders` is RefOrderTracker.neighbour_orders() (original ids).

    Vectorised: every neighbour has an in-edge (edges are bidirectional,
    helper.py:510-518), so both lookups always resolve; edge lookup is a
    searchsorted over (dst, src) keys, dense-id lookup over sorted
    original ids.
    """
    e = len(src)
    mirror = np.arange(e, dtype=np.int32)
    lens = np.fromiter((len(o) if o else 0 for o in orders), np.int64, n)
    total = int(lens.sum())
    if total == 0:
        return mirror
    import itertools
    flat = np.fromiter(itertools.chain.from_iterable(
        o for o in orders if o), np.int64, total)
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    node_of = np.repeat(np.arange(n), lens)
    idx = np.arange(total)
    flat_rev = flat[offs[node_of] + offs[node_of + 1] - 1 - idx]

    sorter = np.argsort(orig_of, kind="stable")
    sorted_ids = orig_of[sorter]
    a_dense = sorter[np.searchsorted(sorted_ids, flat)]
    b_dense = sorter[np.searchsorted(sorted_ids, flat_rev)]

    ekeys = dst.astype(np.int64) * n + src
    esort = np.argsort(ekeys, kind="stable")
    ekeys_s = ekeys[esort]
    qa = node_of * np.int64(n) + a_dense
    qb = node_of * np.int64(n) + b_dense
    pa = np.searchsorted(ekeys_s, qa)
    pb = np.searchsorted(ekeys_s, qb)
    assert np.array_equal(ekeys_s[pa], qa) and np.array_equal(ekeys_s[pb], qb)
    mirror[esort[pa]] = esort[pb].astype(np.int32)
    return mirror


def build_graph_state(
    xyzr: np.ndarray,               # (n, 4) float
    vivl: np.ndarray,               # (n, 2) int  (volume_id, in_volume_layer_id)
    truth_particle: np.ndarray,     # (n,) original particle ids (any int dtype)
    edge_pairs: np.ndarray,         # (m, 2) undirected pairs in file order
    cfg: PipelineConfig,
    dtype=jnp.float64,
    host_extra: Optional[dict] = None,
    precomputed: Optional[dict] = None,
    with_tracker: bool = True,
) -> tuple[GraphState, HostEvent]:
    """precomputed: optional {'mirror': (E,) int32, 'component': (n,) int32}
    from a prior build of the same event (data/event_cache.py) — skips the
    expensive NetworkX-order emulation.  with_tracker=False additionally
    skips RefOrderTracker construction (possible only with a precomputed
    mirror); the leak-emulation parity path then isn't available, which is
    exactly the fast streaming mode (run_pipeline never emulates the leak
    without a tracker)."""
    n = xyzr.shape[0]
    precomputed = precomputed or {}
    cached_slots = "slot_in" in precomputed

    if cached_slots:
        # pairs from the event cache are already the deduped kept set the
        # cached slot tables index (event_cache.save contract)
        pairs = edge_pairs
    else:
        # -- dedupe unordered pairs, keep first occurrence
        #    (helper.py:510-518: re-adding an existing NetworkX edge is a
        #    no-op) --
        a = np.minimum(edge_pairs[:, 0], edge_pairs[:, 1])
        b = np.maximum(edge_pairs[:, 0], edge_pairs[:, 1])
        key = a.astype(np.int64) * n + b
        _, first_idx = np.unique(key, return_index=True)
        keep = np.sort(first_idx)
        pairs = edge_pairs[keep]
        pairs = pairs[pairs[:, 0] != pairs[:, 1]]  # defensive: no self-loops

    m = pairs.shape[0]
    e = 2 * m
    # directed edges in insertion order: 2i = (u->v), 2i+1 = (v->u)
    src = np.empty(e, np.int32)
    dst = np.empty(e, np.int32)
    src[0::2], dst[0::2] = pairs[:, 0], pairs[:, 1]
    src[1::2], dst[1::2] = pairs[:, 1], pairs[:, 0]
    # reverse of edge e is e ^ 1 by this interleaving (relied on by the
    # pair-swap weight lookup, ops/extrapolate.py)

    # -- components (event_conversion.py:84) --
    # the C++ loader's union-find labels ride along in host_extra (verified
    # equal to connected_components_host; CC is invariant to the dedup)
    if "component" in precomputed:
        component = np.asarray(precomputed["component"], np.int32)
    elif host_extra is not None and host_extra.get("components") is not None:
        component = np.asarray(host_extra["components"], np.int32)
    else:
        component = connected_components_host(n, pairs)

    # -- dense layer index over in_volume_layer_id (helper.py:53) --
    layers = np.unique(vivl[:, 1])
    layer_idx = np.searchsorted(layers, vivl[:, 1]).astype(np.int32)

    # -- dense truth particle index (original ids exceed int32) --
    uniq_pids, truth_idx = np.unique(truth_particle, return_inverse=True)
    truth_idx = truth_idx.astype(np.int32)

    # -- fixed-K edge tables in insertion order --
    def edge_table(keys: np.ndarray):
        tab = np.full((n, k), -1, np.int32)
        slot = np.zeros(e, np.int32)
        order = np.argsort(keys, kind="stable")
        sk = keys[order]
        pos = np.arange(e) - np.searchsorted(sk, sk, side="left")
        tab[sk, pos] = order.astype(np.int32)
        slot[order] = pos.astype(np.int32)
        return tab, slot

    if cached_slots:
        # slots are positions within each node's edge list — independent
        # of the table width K, so they survive cfg.max_node_degree
        # changes; the host in/out tables themselves are only needed by
        # the RefOrderTracker (the device rebuilds its own in
        # _device_init's one-writer scatters)
        slot_in = np.asarray(precomputed["slot_in"], np.int32)[:e]
        slot_out = np.asarray(precomputed["slot_out"], np.int32)[:e]
        max_deg = int(max(slot_in.max(initial=-1),
                          slot_out.max(initial=-1))) + 1
        k = cfg.max_node_degree
        while k < max_deg:
            k *= 2
        in_tab = out_tab = None
        if with_tracker:
            in_tab, _ = edge_table(dst)
            out_tab, _ = edge_table(src)
    else:
        in_deg = np.bincount(dst, minlength=n)
        out_deg = np.bincount(src, minlength=n)
        max_deg = int(max(in_deg.max() if n else 0,
                          out_deg.max() if n else 0))
        k = cfg.max_node_degree
        while k < max_deg:
            k *= 2
        in_tab, slot_in = edge_table(dst)
        out_tab, slot_out = edge_table(src)

    # mirror edge per directed edge (reference tau-pairing defect,
    # helper.py:349-429): for each node, the neighbour iteration order is
    # Python set() order over ORIGINAL node ids inserted predecessors-
    # then-successors (set(nx.all_neighbors(G, node)) in the reference);
    # the k-th neighbour's seed state borrows tau from neighbour d-1-k.
    orig_ids = (host_extra or {}).get("node_ids")
    if orig_ids is None:
        orig_ids = np.arange(n, dtype=np.int64)
    orig_of = np.asarray(orig_ids, np.int64)
    tracker = None
    if "mirror" in precomputed:
        mirror = np.asarray(precomputed["mirror"], np.int32)
        if with_tracker:
            tracker = RefOrderTracker(n, src, dst, in_tab, out_tab, orig_of)
    elif not cfg.bug_compat and not with_tracker:
        # clean mode never reads the mirror (ops/seeding.py gates every
        # consumer on cfg.bug_compat) and without a tracker there is no
        # leak replay either — skip the whole NetworkX/CPython order
        # emulation, the dominant cold-ingest cost (~1.9 s full event)
        mirror = np.arange(e, dtype=np.int32)
    else:
        tracker = RefOrderTracker(n, src, dst, in_tab, out_tab, orig_of)
        mirror = compute_mirror(n, src, dst, orig_of,
                                tracker.neighbour_orders())

    # -- pad to buckets --
    n_pad = _round_up(max(n, 1), cfg.node_bucket)
    e_pad = _round_up(max(e, 1), cfg.edge_bucket)

    def padn(x, fill=0):
        out = np.full((n_pad,) + x.shape[1:], fill, x.dtype)
        out[:n] = x
        return out

    def pade(x, fill=0):
        out = np.full((e_pad,) + x.shape[1:], fill, x.dtype)
        out[:e] = x
        return out

    # One jitted program builds every device array from a minimal host
    # set (see _device_init): a single dispatch instead of ~30 eager ops,
    # and ~8 MB host->device instead of ~40 for the full event (edge
    # tables, masks, src/dst, mirror_src and all zero buffers are
    # reconstructed on device).
    # Narrowed transfer dtypes: every byte of the per-event host set is
    # a host->device copy on the stream.  All narrowings are gated on the
    # value range actually fitting and are widened back (bit-exactly) in
    # _device_init; the GraphState dtypes are unchanged.
    narrow_n = n_pad <= 0xFFFF                    # node ids fit uint16
    pairs_dt = np.uint16 if narrow_n else np.int32
    pairs_pad = np.zeros((e_pad // 2, 2), pairs_dt)
    pairs_pad[:m] = pairs.astype(pairs_dt)
    assert k <= np.iinfo(np.uint16).max
    slot_dt = np.uint8 if k <= 256 else np.uint16
    vivl_narrow = (n == 0 or (vivl.min() >= 0
                              and vivl.max() <= np.iinfo(np.uint16).max))
    layer_dt = np.uint8 if len(layers) <= 256 else np.int32
    host_arrays = dict(
        xyzr=padn(xyzr.astype(np.float64)).astype(np.dtype(dtype)),
        vivl=padn(vivl.astype(np.uint16 if vivl_narrow else np.int32)),
        layer_idx=padn(layer_idx.astype(layer_dt)),
        # uint16 truth rides as idx+1 with 0 padding (-1 after widening)
        truth=(padn((truth_idx + 1).astype(np.uint16)) if narrow_n
               else padn(truth_idx, fill=-1)),
        component=padn(component.astype(np.uint16 if narrow_n
                                        else np.int32)),
        pairs=pairs_pad,
        slot_in=pade(slot_in.astype(slot_dt)),
        slot_out=pade(slot_out.astype(slot_dt)),
        n=np.int32(n), e=np.int32(e),
    )
    if cfg.bug_compat:
        # clean mode never reads the mirror (every consumer is gated,
        # ops/seeding.py) — skip the 1.4 MB transfer; device mirror is
        # identity then (pinned by tests/test_graph_build.py)
        host_arrays["mirror"] = pade(mirror)
    dev = _device_init(host_arrays, k)
    g = GraphState(
        n_nodes=n, n_edges=e, max_degree=k, n_layers=len(layers),
        **dev)
    host = HostEvent(
        node_ids=(host_extra or {}).get("node_ids", np.arange(n)),
        particle_ids=uniq_pids,
        hit_ids=(host_extra or {}).get("hit_ids"),
        hit_particle_ids=(host_extra or {}).get("hit_particle_ids"),
        module_ids=(host_extra or {}).get("module_ids"),
        tracker=tracker,
        mirror=np.asarray(mirror, np.int32),
    )
    return g, host
