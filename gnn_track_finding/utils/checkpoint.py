"""Checkpoint / resume of the device graph state.

The reference's de-facto checkpointing is the gpickle-per-subgraph snapshot
after every stage (helper.py:585-587; restart by re-pointing INPUT at an
iteration directory, run_gnn_trackml_mod.sh:74-76).  Here the whole padded
GraphState is one pytree, checkpointed at iteration boundaries with orbax
(async-capable, multi-host aware), plus the host-side candidate ledger.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional, Tuple

import numpy as np

from gnn_track_finding.graph.state import GraphState


_META_FIELDS = ("n_nodes", "n_edges", "max_degree", "n_layers")


def save(path: str, g: GraphState, candidates: Optional[List] = None,
         iteration: int = 0) -> None:
    import orbax.checkpoint as ocp

    path = os.path.abspath(path)
    ckpt = ocp.StandardCheckpointer()
    arrays = {f.name: getattr(g, f.name)
              for f in dataclasses.fields(g) if f.name not in _META_FIELDS}
    ckpt.save(os.path.join(path, f"graph_{iteration}"), arrays)
    ckpt.wait_until_finished()
    meta = {k: getattr(g, k) for k in _META_FIELDS}
    meta["iteration"] = iteration
    if candidates is not None:
        meta["candidates"] = [
            {"nodes": np.asarray(c.nodes).tolist(), "iteration": c.iteration,
             "pval_xy": c.pval_xy, "pval_zr": c.pval_zr}
            for c in candidates]
    with open(os.path.join(path, f"meta_{iteration}.json"), "w") as f:
        json.dump(meta, f)


def restore(path: str, template: GraphState, iteration: int = 0
            ) -> Tuple[GraphState, List]:
    import orbax.checkpoint as ocp
    from gnn_track_finding.models.pipeline import Candidate

    path = os.path.abspath(path)
    ckpt = ocp.StandardCheckpointer()
    arrays = {f.name: getattr(template, f.name)
              for f in dataclasses.fields(template)
              if f.name not in _META_FIELDS}
    restored = ckpt.restore(os.path.join(path, f"graph_{iteration}"), arrays)
    with open(os.path.join(path, f"meta_{iteration}.json")) as f:
        meta = json.load(f)
    g = template.replace(**restored)
    candidates = [Candidate(nodes=np.asarray(c["nodes"]),
                            iteration=c["iteration"],
                            pval_xy=c["pval_xy"], pval_zr=c["pval_zr"])
                  for c in meta.get("candidates", [])]
    return g, candidates
