"""Efficiency sweep over the reference's exposed CLI parameters.

The committed reference configuration reconstructs 0 tracks on its own
data at every volume measured (BASELINE.md).  This sweep searches the
parameter space the reference itself exposes (run_gnn_trackml_mod.sh:4-37:
clustering chi2/KL thresholds, extrapolation chi2 cut c, acceptance p,
sigmas, iteration count) for any configuration with nonzero
reconstruction efficiency — bug-compatible mode, so a hit here is a
configuration the patched reference can be re-run on for a two-sided
comparison.

The efficiency needs the event's particle table, which the committed
snapshots do not carry, so the event is read from the CSVs of a checkout
of the reference repository (--reference).

Usage: python tools/sweep_efficiency.py --reference DIR [--volumes 9 9] [--quick]
"""

from __future__ import annotations

import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import dataclasses
import itertools
import json


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--volumes", nargs=2, type=int, default=[9, 9])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--reference", required=True,
                    help="checkout of the reference repository")
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from gnn_track_finding.utils import platform
    platform.enable_compile_cache()
    import jax.numpy as jnp

    from gnn_track_finding.config import PipelineConfig
    from gnn_track_finding.data import trackml
    from gnn_track_finding.evaluation import efficiency
    from gnn_track_finding.models import pipeline

    base = PipelineConfig(min_volume=args.volumes[0],
                          max_volume=args.volumes[1])
    event = trackml.reference_event(args.reference)
    g0, host = trackml.load_event(event, base,
                                  dtype=jnp.float64)
    print(f"[sweep] volumes {args.volumes}: {g0.n_nodes} nodes "
          f"{g0.n_edges} edges", file=_sys.stderr)

    chi2_seed = [0.25, 1.0] if args.quick else [0.1, 0.25, 0.5, 1.0]
    kl_seed = [0.5, 2.0] if args.quick else [0.25, 0.5, 1.0, 2.0]
    cuts = [1.0, 2.0] if args.quick else [0.5, 1.0, 2.0]
    pvals = [0.01] if args.quick else [0.01, 0.1]
    iters = [3] if args.quick else [3, 5]

    best = None
    for cs, ks, c, p, it in itertools.product(chi2_seed, kl_seed, cuts,
                                              pvals, iters):
        cfg = dataclasses.replace(
            base, chi2_threshold_seed=cs, kl_threshold_seed=ks,
            chi2_cut_factor=c, track_acceptance_pval=p, num_iterations=it)
        out = pipeline.run_pipeline(g0, cfg,
                                    tracker=getattr(host, "tracker", None))
        rep = efficiency.evaluate(
            [cand.nodes for cand in out.candidates], host,
            event.particles_csv, event.truth_csv, cfg)
        jax.clear_caches()   # one jit cache per static cfg otherwise OOMs
        row = {"chi2_seed": cs, "kl_seed": ks, "c": c, "p": p, "iters": it,
               "candidates": len(out.candidates),
               "reconstructed": rep.num_reconstructed,
               "reference": rep.num_reference,
               "efficiency_pct": round(rep.efficiency_pct, 3)}
        print(json.dumps(row), flush=True)
        if best is None or rep.num_reconstructed > best[0]:
            best = (rep.num_reconstructed, row)
    print("[sweep] best:", json.dumps(best[1]), file=_sys.stderr)


if __name__ == "__main__":
    main()
