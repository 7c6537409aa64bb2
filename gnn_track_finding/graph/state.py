"""Padded struct-of-arrays graph state — the device-resident data model.

The reference keeps its state as dict-of-dicts on NetworkX nodes, pickled to
disk between pipeline stages (node/edge attribute schema implicit in
helper.py:432-450,498-508; gpickle IO at helper.py:585-587).  Here the whole
event lives in one pytree of fixed-shape arrays that stays on device across
all iterations; stages are jitted pure functions GraphState -> GraphState.

Orientation convention.  Every undirected hit pair is represented by TWO
directed edges, matching the reference's bidirectional DiGraph
(helper.py:510-518).  For a directed edge e = (src -> dst):

  * the SEED state of e is the reference's
    ``G.nodes[dst]['track_state_estimates'][src]`` — the per-edge parabolic
    estimate owned by the head node, keyed by the tail
    (helper.py:432-441; prior check of edge (neighbour, node) at
    helper.py:49-52).
  * the UPDATED state of e is
    ``G.nodes[dst]['updated_track_states'][src]`` — written during message
    passing when src extrapolates its merged state across e
    (extrapolate_merged_states.py:441-447).
  * ``active[e]`` is the reference's per-directed-edge ``activated`` flag
    (helper.py:24-25); the reverse edge is deactivated independently.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp


def pytree_dataclass(cls):
    """A frozen dataclass registered as a JAX pytree, with `.replace`.

    Fields made with `static_field()` are hashable aux data (part of the
    jit key, never traced); every other field is a pytree child."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = dataclasses.replace
    return jax.tree_util.register_dataclass(cls)


def static_field():
    return dataclasses.field(metadata={"static": True})


def is_static(f: dataclasses.Field) -> bool:
    return bool(f.metadata.get("static"))


@pytree_dataclass
class GraphState:
    # ---- static metadata (hashable aux data, not traced) ----
    n_nodes: int = static_field()      # true node count
    n_edges: int = static_field()      # true directed edge count
    max_degree: int = static_field()   # K of the edge tables
    n_layers: int = static_field()     # distinct vivl layers

    # ---- node arrays, padded to N ----
    node_mask: jax.Array      # (N,)   bool: node still in the graph
    xyzr: jax.Array           # (N,4)  hit coordinates (x, y, z, r) — the
    #                                  reference's immutable 'xyzr' attribute
    # live GNN_Measurement coordinates: identical to xyzr until an
    # extraction-stage close-proximity merge mutates the shared
    # GNN_Measurement object (extract_track_candidates.py:113-116 — the
    # mutation leaks through every shallow Graph.copy() into the remaining
    # network).  Message passing reads THESE; everything keyed to the
    # 'xyzr' attribute (clustering node coords, extraction sort/merge
    # distances) keeps reading xyzr.  bug_compat drivers apply the leak
    # via graph/nxorder.RefOrderTracker; clean mode never mutates.
    gnn_xyzr: jax.Array       # (N,4)
    vivl: jax.Array           # (N,2)  int32 (volume_id, in_volume_layer_id)
    layer_idx: jax.Array      # (N,)   int32 dense layer index in [0, n_layers)
    truth: jax.Array          # (N,)   int32 dense truth-particle index (-1 pad)
    component: jax.Array      # (N,)   int32 connected-component label
    degree: jax.Array         # (N,)   int32 active in-degree (helper.py:67-73)

    has_merged: jax.Array     # (N,)   bool: clustering produced a merged state
    merged_state: jax.Array   # (N,3)  parabolic [a, b, c]
    merged_cov: jax.Array     # (N,3,3)
    merged_prior: jax.Array   # (N,)

    # per-node edge-orientation statistics (helper.py:446-447), the
    # 'empirical variance' feature of the KL calibration LUT (section 2.2)
    grad_stats: jax.Array     # (N,4) [mean_xy, var_xy, mean_zr, var_zr]

    # ---- directed edge arrays, padded to E ----
    edge_mask: jax.Array      # (E,)   bool: edge exists (both endpoints alive)
    src: jax.Array            # (E,)   int32 tail node
    dst: jax.Array            # (E,)   int32 head node (owns the edge state)
    # NOTE: the (dst -> src) reverse of edge e is e ^ 1 BY CONSTRUCTION
    # (build.py interleaves each pair); ops use the pair swap directly, so
    # no reverse-index array is stored.
    active: jax.Array         # (E,)   bool 'activated' flag

    seed_sv: jax.Array        # (E,3)   parabolic [a, b, c] seed
    seed_cov: jax.Array       # (E,3,3)
    seed_joint: jax.Array     # (E,3)   joint [a, b, tau]
    seed_joint_cov: jax.Array  # (E,3,3)
    seed_prior: jax.Array     # (E,)
    seed_weight: jax.Array    # (E,)

    has_updated: jax.Array    # (E,)   bool: updated state present
    upd_sv: jax.Array         # (E,3)
    upd_cov: jax.Array        # (E,3,3)
    upd_joint: jax.Array      # (E,3)
    upd_joint_cov: jax.Array  # (E,3,3)
    upd_prior: jax.Array      # (E,)
    upd_weight: jax.Array     # (E,)
    upd_likelihood: jax.Array  # (E,)
    # tail GNN coordinates snapshot taken when the updated state was
    # written — the reference stores (node_x, ..., node_r) INSIDE the
    # updated_track_states dict (extrapolate_merged_states.py:374-377) and
    # reads them back for clustering neighbour coords (clustering.py:218)
    # and reweight side norms (helper.py:113), so later coordinate
    # mutations must not bleed into those consumers.
    upd_xyzr: jax.Array       # (E,4)

    # ---- per-node fixed-K edge tables (insertion order == CSV edge order,
    #      reproducing NetworkX adjacency iteration order) ----
    in_edges: jax.Array       # (N,K) int32 edge indices with dst == node, -1 pad
    out_edges: jax.Array      # (N,K) int32 edge indices with src == node, -1 pad
    # inverse maps: e == in_edges[dst[e], slot_in[e]] == out_edges[src[e],
    # slot_out[e]].  They turn every table->edge scatter into a gather.
    slot_in: jax.Array        # (E,) int32
    slot_out: jax.Array       # (E,) int32
    # static pre-gathered endpoint data: [xyzr[src] | xyzr[dst]] per edge.
    # Coordinates never change, so this removes per-stage dynamic gathers
    # (and edge-table lookups gather whole width-8 rows).
    e_xyzr: jax.Array         # (E, 8)
    e_src_layer: jax.Array    # (E,) int32 dense layer index of the tail
    # static head (dst) coordinates of each out-table slot: per-slot
    # quantities are computed from this cache instead of gathering
    # (E,)-arrays through the table.
    out_head_xyzr: jax.Array  # (N, K, 4)
    # static tail (src) x coordinate of each in-table slot (reweight's
    # side-norm distinct-count runs as row sorts over this cache)
    in_src_x: jax.Array       # (N, K)
    # static tail (src) dense layer index of each in-table slot (-1 pad):
    # the prior's per-(node, layer) eligible-count reduces over the table
    # instead of a segment scatter (ops/priors.prior_reweight)
    in_src_layer: jax.Array   # (N, K) int32
    # static mirror edge for the reference's tau/parabola pairing defect:
    # helper.py:349-375 reverses coords/keys but indexes the tau/theta
    # lists with the un-reversed loop variable, so the seed state of the
    # k-th neighbour (in Python-set iteration order over ORIGINAL node
    # ids) carries the tau of neighbour d-1-k.  mirror[e] is that donor
    # edge; bug_compat seeding reads tau quantities through it.
    mirror: jax.Array         # (E,) int32
    # static tail node id of the mirror edge (src[mirror]): under the edge
    # partition the donor tau/variance are RECOMPUTED from this (node
    # coords are replicated) instead of gathered across shards — bitwise
    # identical because e_xyzr's tail columns are xyzr[src] by construction
    mirror_src: jax.Array     # (E,) int32

    @property
    def num_padded_nodes(self) -> int:
        return self.node_mask.shape[0]

    @property
    def num_padded_edges(self) -> int:
        return self.edge_mask.shape[0]

    @property
    def dtype(self) -> Any:
        return self.xyzr.dtype


def blank_state(n_pad: int, e_pad: int, k: int, n_layers: int,
                dtype=jnp.float32) -> GraphState:
    """Allocate an all-padding GraphState (used for shape probing/tests)."""
    f = lambda *s: jnp.zeros(s, dtype)
    i = lambda *s: jnp.zeros(s, jnp.int32)
    b = lambda *s: jnp.zeros(s, bool)
    return GraphState(
        n_nodes=0, n_edges=0, max_degree=k, n_layers=n_layers,
        node_mask=b(n_pad), xyzr=f(n_pad, 4), gnn_xyzr=f(n_pad, 4),
        vivl=i(n_pad, 2),
        layer_idx=i(n_pad), truth=jnp.full((n_pad,), -1, jnp.int32),
        component=i(n_pad), degree=i(n_pad),
        has_merged=b(n_pad), merged_state=f(n_pad, 3),
        merged_cov=f(n_pad, 3, 3), merged_prior=f(n_pad),
        grad_stats=f(n_pad, 4),
        edge_mask=b(e_pad), src=i(e_pad), dst=i(e_pad),
        active=b(e_pad),
        seed_sv=f(e_pad, 3), seed_cov=f(e_pad, 3, 3),
        seed_joint=f(e_pad, 3), seed_joint_cov=f(e_pad, 3, 3),
        seed_prior=f(e_pad), seed_weight=f(e_pad),
        has_updated=b(e_pad), upd_sv=f(e_pad, 3), upd_cov=f(e_pad, 3, 3),
        upd_joint=f(e_pad, 3), upd_joint_cov=f(e_pad, 3, 3),
        upd_prior=f(e_pad), upd_weight=f(e_pad), upd_likelihood=f(e_pad),
        upd_xyzr=f(e_pad, 4),
        in_edges=jnp.full((n_pad, k), -1, jnp.int32),
        out_edges=jnp.full((n_pad, k), -1, jnp.int32),
        slot_in=i(e_pad), slot_out=i(e_pad),
        e_xyzr=f(e_pad, 8), e_src_layer=i(e_pad),
        out_head_xyzr=f(n_pad, k, 4),
        in_src_x=f(n_pad, k),
        in_src_layer=jnp.full((n_pad, k), -1, jnp.int32),
        mirror=i(e_pad),
        mirror_src=i(e_pad),
    )
