"""Validate device states against the reference pipeline's outputs.

Compares per-edge seed states, per-node merged states, the extraction
coordinate leak, and iteration-2 updated states from this framework's
device pipeline against the reference artifacts — allclose, per
node/edge, reported as match fractions.

Two sources for the reference side:
- a live baseline run's gpickles (default /tmp/ref_baseline/src/output,
  produced by `tools/make_ref_baseline.py --run`), distilled on the fly;
- the committed digest tests/data/ref_digest.npz (produced by
  `tools/make_ref_digest.py` from a live run) — the hermetic path used
  by tests/test_reference_artifacts.py.

Reference schema: `src/utilities/helper.py:432-450` state dicts as
pickled by `helper.py:585-587`; updated states written by
`extrapolate_merged_states.py:441-447`.

Usage (on the GPU; JAX_PLATFORMS=cpu runs it on the CPU):
  python tools/validate_vs_reference.py [REF_OUTPUT_DIR]
  python tools/validate_vs_reference.py --digest [NPZ_PATH]
"""

from __future__ import annotations

import glob
import os
import pickle
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIGEST_PATH = os.path.join(REPO, "tests", "data", "ref_digest.npz")


def _ref_sys_path(ref_root: str) -> None:
    """The gpickles reference the run's GNN_Measurement class by module."""
    base = os.path.dirname(os.path.dirname(ref_root))
    for p in (os.path.join(base, "src"), base):
        if os.path.isdir(p) and p not in sys.path:
            sys.path.insert(0, p)


def load_ref_graphs(directory: str):
    graphs = []
    for path in sorted(glob.glob(os.path.join(directory, "*_subgraph.gpickle"))):
        with open(path, "rb") as f:
            graphs.append(pickle.load(f))
    return graphs


def compute_framework_states():
    """Run the framework pipeline on the volume-7 snapshot to the
    iteration-2 boundary (float64, on the process's default device) and
    return every array the parity comparison needs."""
    import jax
    from gnn_track_finding.config import PipelineConfig
    from gnn_track_finding.data import trackml
    from gnn_track_finding.models import pipeline

    cfg = PipelineConfig()
    g, host = trackml.load_event("trackml_v7", cfg)
    g = pipeline._prepare_jit(g, cfg)

    out = {"remap": {int(n): i for i, n in enumerate(host.node_ids)}}
    out["src"] = np.asarray(g.src)
    out["dst"] = np.asarray(g.dst)
    out["seed_sv"] = np.asarray(g.seed_sv)
    out["seed_cov"] = np.asarray(g.seed_cov)
    out["edge_index"] = {(int(out["src"][e]), int(out["dst"][e])): e
                         for e in range(g.n_edges)}

    # replicate the host driver: clustering stage, extraction, then the
    # extraction leak (close-proximity merges mutate GNN coordinates in
    # place — graph/nxorder.py) before the next stage
    g1s = jax.jit(pipeline.stage_step, static_argnums=(1, 2))(g, cfg, 1)
    g1, res1 = pipeline._extract_only_jit(g1s, cfg, None)
    n_acc = int(res1.acc_count)
    acc_sets = []
    if n_acc:
        mat = np.asarray(res1.acc_nodes[:n_acc])
        acc_sets = [set(int(x) for x in row[row >= 0]) for row in mat]
    muts = host.tracker.extraction_merges(
        np.asarray(g1s.edge_mask & g1s.active), np.asarray(g.vivl),
        np.asarray(g.xyzr, np.float64), acc_sets,
        cfg.min_track_hits, cfg.node_merge_distance)
    out["muts"] = {n: c for n, c in muts}
    if muts:
        g1 = pipeline._apply_gnn_mutations(
            g1, muts, np.asarray(g.in_edges), np.asarray(g.slot_out),
            np.asarray(g.src))
    out["has_merged"] = np.asarray(g1.has_merged)
    out["merged_state"] = np.asarray(g1.merged_state)
    out["merged_cov"] = np.asarray(g1.merged_cov)

    g2 = jax.jit(pipeline.stage_step, static_argnums=(1, 2))(g1, cfg, 2)
    out["has_updated"] = np.asarray(g2.has_updated)
    out["upd_sv"] = np.asarray(g2.upd_sv)
    out["upd_joint"] = np.asarray(g2.upd_joint)
    return out


def compare(digest: dict, fw: dict, log=print) -> dict:
    """Compare a reference digest against framework states; return match
    fractions (all in [0,1])."""
    remap, edge_index = fw["remap"], fw["edge_index"]
    res = {}

    # ---- seed states ----
    n_cmp = n_ok = n_cov_ok = 0
    for so, do, sv, cov in zip(digest["seed_src"], digest["seed_dst"],
                               digest["seed_sv"], digest["seed_cov"]):
        s, d = remap.get(int(so)), remap.get(int(do))
        if s is None or d is None:
            continue
        e = edge_index.get((s, d))
        if e is None:
            continue
        n_cmp += 1
        n_ok += np.allclose(fw["seed_sv"][e], sv, rtol=1e-8, atol=1e-12)
        n_cov_ok += np.allclose(fw["seed_cov"][e], cov, rtol=1e-7, atol=1e-12)
    res["seed_cmp"] = n_cmp
    res["seed_sv"] = n_ok / max(n_cmp, 1)
    res["seed_cov"] = n_cov_ok / max(n_cmp, 1)
    log(f"[seed] edges compared: {n_cmp}, state allclose: {n_ok} "
        f"({100.0 * res['seed_sv']:.3f}%), cov allclose: {n_cov_ok} "
        f"({100.0 * res['seed_cov']:.3f}%)")

    # ---- extraction coordinate leak ----
    ours = fw["muts"]
    ok_mut = 0
    for no, co in zip(digest["leak_node"], digest["leak_coords"]):
        d = remap.get(int(no))
        if d in ours and np.allclose(ours[d], co):
            ok_mut += 1
    n_leak = len(digest["leak_node"])
    res["leak"] = ok_mut / max(n_leak, 1)
    log(f"[leak] reference remaining has {n_leak} mutated nodes; predicted "
        f"{len(ours)} (incl. removed-candidate nodes); matching coords: "
        f"{ok_mut}/{n_leak}")

    # ---- clustering iteration 1 merged states ----
    hm, ms, mc = fw["has_merged"], fw["merged_state"], fw["merged_cov"]
    m_cmp = m_flag_ok = m_val_ok = 0
    mi = 0
    n_ref_merged = int(np.asarray(digest["clus_has_merged"]).sum())
    for no, has in zip(digest["clus_node"], digest["clus_has_merged"]):
        rsv = digest["clus_merged_sv"][mi] if has else None
        rcov = digest["clus_merged_cov"][mi] if has else None
        mi += bool(has)
        d = remap.get(int(no))
        if d is None:
            continue
        m_cmp += 1
        if bool(hm[d]) == bool(has):
            m_flag_ok += 1
            if has and np.allclose(ms[d], rsv, rtol=1e-7, atol=1e-12) \
                    and np.allclose(mc[d], rcov, rtol=1e-6, atol=1e-12):
                m_val_ok += 1
    res["clus_cmp"] = m_cmp
    res["clus_flag"] = m_flag_ok / max(m_cmp, 1)
    res["clus_val"] = m_val_ok / max(n_ref_merged, 1)
    log(f"[cluster1] nodes compared: {m_cmp}, merged-flag match: {m_flag_ok} "
        f"({100.0 * res['clus_flag']:.3f}%), merged values allclose: "
        f"{m_val_ok}/{n_ref_merged} ({100.0 * res['clus_val']:.3f}%)")

    # ---- extrapolation iteration 2 updated states ----
    # the reference writes iteration_2/network right after message passing
    # (extrapolate_merged_states.py:561-571), BEFORE extraction and the
    # even-iteration metadata pruning — the digest captures that boundary.
    has_u, usv, ujoint = fw["has_updated"], fw["upd_sv"], fw["upd_joint"]
    u_cmp = u_flag = u_val = u_joint = 0
    for so, do, sv, joint in zip(digest["upd_src"], digest["upd_dst"],
                                 digest["upd_sv"], digest["upd_joint"]):
        s, d = remap.get(int(so)), remap.get(int(do))
        if s is None or d is None:
            continue
        e = edge_index.get((s, d))
        if e is None:
            continue
        u_cmp += 1
        if has_u[e]:
            u_flag += 1
            u_val += np.allclose(usv[e], sv, rtol=1e-6, atol=1e-10)
            u_joint += np.allclose(ujoint[e], joint, rtol=1e-6, atol=1e-10)
    res["upd_cmp"] = u_cmp
    res["upd_flag"] = u_flag / max(u_cmp, 1)
    res["upd_val"] = u_val / max(u_cmp, 1)
    res["upd_joint"] = u_joint / max(u_cmp, 1)
    log(f"[extrap2] updated states compared: {u_cmp}, present here: {u_flag} "
        f"({100.0 * res['upd_flag']:.3f}%), values allclose: {u_val} "
        f"({100.0 * res['upd_val']:.3f}%), joint allclose: {u_joint} "
        f"({100.0 * res['upd_joint']:.3f}%)")
    return res


def load_digest(path: str = DIGEST_PATH) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def run_validation(digest: dict | None = None, log=print) -> dict:
    import jax
    from gnn_track_finding.utils import platform
    jax.config.update("jax_enable_x64", True)
    platform.require_gpu()
    platform.enable_compile_cache()
    if digest is None:
        digest = load_digest()
    return compare(digest, compute_framework_states(), log=log)


def main() -> None:
    args = sys.argv[1:]
    if args and args[0] == "--digest":
        digest = load_digest(args[1] if len(args) > 1 else DIGEST_PATH)
        print(f"[source] committed digest ({DIGEST_PATH})")
    else:
        ref_root = args[0] if args else "/tmp/ref_baseline/src/output"
        if os.path.isdir(os.path.join(ref_root, "track_sim", "network")):
            from tools.make_ref_digest import build_digest
            digest = build_digest(ref_root)
            print(f"[source] live reference artifacts ({ref_root})")
        elif os.path.exists(DIGEST_PATH):
            digest = load_digest()
            print(f"[source] no live artifacts at {ref_root}; falling back "
                  f"to committed digest ({DIGEST_PATH})")
        else:
            print(f"no reference artifacts at {ref_root} and no digest; "
                  "run tools/make_ref_baseline.py --run first")
            return
    run_validation(digest)


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    main()
