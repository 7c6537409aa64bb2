"""Collective accounting + simulated scaling for the edge partition.

Compares two lowerings of the extrapolation stage over an 8-virtual-device
CPU "edge" mesh on the full TrackML event:

  1. auto-SPMD: jit with NamedSharding over the edge axis on every array
     axis (the parallel/mesh.py approach) — XLA infers the communication;
  2. shard_map: parallel/edge_shard.py — edge arrays partitioned, node
     arrays replicated, explicit psum combines (ops/collect).

For each it reports the collective ops in the compiled HLO (kind, count,
total bytes) and a timed iteration at 1/2/4/8 shards.  Run on CPU — the
point is the communication structure, not wall-clock (virtual devices
share one host's cores).

Usage: python tools/profile_edge_shard.py [--volumes 7 14] [--n 5]
"""

from __future__ import annotations

import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import collections
import re
import time

_os.environ["JAX_PLATFORMS"] = "cpu"
_os.environ["XLA_FLAGS"] = (_os.environ.get("XLA_FLAGS", "")
                            + " --xla_force_host_platform_device_count=8")


def collective_stats(hlo_text: str) -> dict:
    """Histogram of collective ops in compiled HLO: name -> (count, bytes)."""
    out = collections.defaultdict(lambda: [0, 0])
    # HLO op line: `%name = f32[128,64]{1,0} all-reduce(...)` or a tuple
    # shape before an `-start` variant
    pat = re.compile(
        r"= ((?:\([^)]*\)|\w+\[[\d,]*\])[^\n=]*?)\s"
        r"((?:all-reduce|all-gather|all-to-all|collective-permute|"
        r"reduce-scatter)(?:-start)?)\(")
    dtype_bytes = {"f64": 8, "f32": 4, "s32": 4, "u32": 4, "pred": 1,
                   "s8": 1, "u8": 1, "bf16": 2, "f16": 2, "s64": 8}
    for m in pat.finditer(hlo_text):
        shape_txt, op = m.group(1), m.group(2)
        nbytes = 0
        for st in re.finditer(r"(\w+)\[([\d,]*)\]", shape_txt):
            dt, dims = st.group(1), st.group(2)
            n = 1
            for d in dims.split(","):
                if d:
                    n *= int(d)
            nbytes += n * dtype_bytes.get(dt, 4)
        key = op.replace("-start", "")
        out[key][0] += 1
        out[key][1] += nbytes
    return {k: tuple(v) for k, v in out.items()}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--volumes", nargs=2, type=int, default=[7, 14])
    ap.add_argument("--n", type=int, default=5)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    assert jax.default_backend() == "cpu" and len(jax.devices()) >= 8, (
        jax.default_backend(), jax.devices())
    from gnn_track_finding.utils import platform
    platform.enable_compile_cache()

    from gnn_track_finding.config import PipelineConfig
    from gnn_track_finding.data import snapshots, trackml
    from gnn_track_finding.models import pipeline
    from gnn_track_finding.parallel import edge_shard

    cfg = PipelineConfig(min_volume=args.volumes[0],
                         max_volume=args.volumes[1])
    dtype = jnp.float32
    g, _ = trackml.load_event(
        snapshots.for_volumes(cfg.min_volume, cfg.max_volume), cfg,
        dtype=dtype)
    print(f"[edge_shard] N={g.num_padded_nodes} E={g.num_padded_edges} "
          f"K={g.max_degree} devices={len(jax.devices())}", file=_sys.stderr)
    g = pipeline._prepare_jit(g, cfg)
    g = pipeline._stage_jit(g, cfg, 1, None)

    def timed(fn, gx, n):
        out = fn(gx)
        jax.block_until_ready(out)
        t0 = time.time()
        for _ in range(n):
            out = fn(gx)
        jax.block_until_ready(out)
        return (time.time() - t0) / n

    results = {}
    for n_dev in (1, 2, 4, 8):
        mesh = edge_shard.edge_mesh(n_dev)
        gs = edge_shard.shard_graph(g, mesh)
        fn = edge_shard.extrapolation_stage_sharded(cfg, mesh)
        txt = fn.lower(gs).compile().as_text()
        dt = timed(fn, gs, args.n)
        results[("shard_map", n_dev)] = (collective_stats(txt), dt)

    # node-owner all_to_all routing (edge_shard.OwnerRouting)
    for n_dev in (2, 4, 8):
        mesh = edge_shard.edge_mesh(n_dev)
        routing = edge_shard.build_owner_routing(g, n_dev)
        print(f"[edge_shard] routing n_dev={n_dev}: bucket={routing.bucket} "
              f"(ideal {g.n_edges // (n_dev * n_dev)})", file=_sys.stderr)
        gs = edge_shard.shard_graph(g, mesh)
        fn = edge_shard.extrapolation_stage_sharded(cfg, mesh,
                                                    routing=routing)
        txt = fn.lower(gs).compile().as_text()
        dt = timed(fn, gs, args.n)
        results[("owner_a2a", n_dev)] = (collective_stats(txt), dt)

    # auto-SPMD: every array axis sharded over the edge axis, XLA infers
    for n_dev in (8,):
        mesh = edge_shard.edge_mesh(n_dev)

        def auto_spec(x):
            return NamedSharding(mesh, P("edge") if x.ndim >= 1 else P())
        shardings = jax.tree.map(auto_spec, g)
        ga = jax.tree.map(jax.device_put, g, shardings)
        fn = jax.jit(lambda gg: pipeline.extrapolation_stage(gg, cfg),
                     in_shardings=(shardings,))
        txt = fn.lower(ga).compile().as_text()
        dt = timed(fn, ga, args.n)
        results[("auto_spmd", n_dev)] = (collective_stats(txt), dt)

    print(f"\n{'variant':12s} {'shards':>6s} {'ms/iter':>9s}  collectives")
    for (name, n_dev), (stats, dt) in sorted(results.items()):
        desc = "; ".join(f"{k} x{v[0]} ({v[1] / 1e6:.1f} MB)"
                         for k, v in sorted(stats.items())) or "none"
        print(f"{name:12s} {n_dev:6d} {dt * 1e3:9.1f}  {desc}")


if __name__ == "__main__":
    main()
