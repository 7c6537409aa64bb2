"""Directional tag propagation — the reference's parallel-CCA experiment.

Re-design of tag_propagation/tag_propagation.py:64-167: every node starts
with its own tag; each round a node adopts the min (or max) tag among its
INWARD neighbours — those at smaller radius, respecting track direction —
and iteration stops when fewer than `flip_fraction` of nodes changed.
The reference flags its node loop "TODO: parallelize this"; here a round
is two masked row-gathers over the edge tables and the loop is a
lax.while_loop on the flip fraction.

(The production CCA is graph/cca.py; this module exists for parity with
the reference's experimental extractor and as a directional primitive.)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from gnn_track_finding.graph.state import GraphState
from gnn_track_finding.ops import gtools


def propagate_tags(g: GraphState, edge_ok=None, minimize: bool = True,
                   flip_fraction: float = 0.10) -> jax.Array:
    """Tags after convergence (<flip_fraction of nodes changing per round).

    A node pulls tags only from neighbours with SMALLER radius
    (tag_propagation.py:99-116): information flows outward along tracks.
    """
    n = g.num_padded_nodes
    edge_ok = g.edge_mask if edge_ok is None else edge_ok

    in_e = jnp.maximum(g.in_edges, 0)
    out_e = jnp.maximum(g.out_edges, 0)
    # inward = neighbour radius smaller than the node's
    r_node = g.xyzr[:, 3:4]
    in_nb = g.src[in_e]
    out_nb = g.dst[out_e]
    in_src_r = g.e_xyzr[in_e][..., 3]        # static src radius per in-slot
    in_ok = ((g.in_edges >= 0) & gtools.gather1d(edge_ok, in_e)
             & (in_src_r < r_node))
    out_ok = ((g.out_edges >= 0) & gtools.gather1d(edge_ok, out_e)
              & (g.out_head_xyzr[..., 3] < r_node))

    init = jnp.arange(n, dtype=jnp.int32)
    limit = jnp.int32(n)
    reducer = jnp.minimum if minimize else jnp.maximum
    fill = limit if minimize else jnp.int32(-1)

    def body(state):
        tags, _ = state
        t_in = jnp.where(in_ok, gtools.gather1d(tags, in_nb), fill)
        t_out = jnp.where(out_ok, gtools.gather1d(tags, out_nb), fill)
        t_in = (t_in.min(axis=1) if minimize else t_in.max(axis=1))
        t_out = (t_out.min(axis=1) if minimize else t_out.max(axis=1))
        new = reducer(tags, reducer(t_in, t_out))
        flips = jnp.sum((new != tags) & g.node_mask)
        frac = flips / jnp.maximum(jnp.sum(g.node_mask), 1)
        return new, frac >= flip_fraction

    tags, _ = jax.lax.while_loop(lambda s: s[1], body,
                                 (init, jnp.bool_(True)))
    return jnp.where(g.node_mask, tags, init)
