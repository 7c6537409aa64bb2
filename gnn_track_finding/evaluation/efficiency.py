"""Track reconstruction efficiency and purity.

Host-side re-statement of src/extract/reconstruction_efficiency.py:

  * reference tracks: particles with pT >= 1 GeV (:42-47), hits restricted
    to the analysed volumes (:56-59), >= 4 distinct (volume, layer) pairs
    (:66-75), one hit per module (:78-86);
  * candidate matching: majority particle id over the candidate's
    constituent hits (:127-142), matched when n_good >= 0.5 x reference
    hits and both track purity (n_good / candidate hits) and particle
    purity (n_good / particle hits in region) reach 0.5, with a
    double-count guard (:155-187);
  * efficiency = reconstructed / reference x 100 (:213-218).
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Dict, List, Sequence

import numpy as np

from gnn_track_finding.config import PipelineConfig
from gnn_track_finding.graph.build import HostEvent


@dataclasses.dataclass
class EfficiencyReport:
    num_reference: int
    num_reconstructed: int
    efficiency_pct: float
    track_purities: np.ndarray
    particle_purities: np.ndarray


def reference_tracks(particles_csv: str, truth_csv: str,
                     cfg: PipelineConfig) -> Dict[int, List[int]]:
    import pandas as pd     # CSV path only: pandas is an optional dependency
    particles = pd.read_csv(particles_csv)
    pt = np.hypot(particles["px"].to_numpy(), particles["py"].to_numpy())
    good_pids = set(particles.loc[pt >= cfg.eval_pt_cut, "particle_id"]
                    .astype(np.int64).tolist())

    hits = pd.read_csv(truth_csv)
    hits = hits.loc[(hits["volume_id"] >= cfg.min_volume)
                    & (hits["volume_id"] <= cfg.max_volume)]
    hits = hits.loc[hits["particle_id"].isin(good_pids)]

    out: Dict[int, List[int]] = {}
    for pid, grp in hits.groupby("particle_id", sort=False):
        layers = set(zip(grp["volume_id"], grp["layer_id"]))
        if len(layers) < cfg.eval_min_layers:
            continue
        dup = grp.duplicated(["volume_id", "layer_id", "module_id"], keep=False)
        if dup.any():
            continue  # > 1 hit per module (ref :78-86)
        out[int(pid)] = grp["hit_id"].astype(np.int64).tolist()
    return out


def hits_in_region(truth_csv: str, cfg: PipelineConfig) -> Dict[int, int]:
    import pandas as pd
    hits = pd.read_csv(truth_csv)
    hits = hits.loc[(hits["volume_id"] >= cfg.min_volume)
                    & (hits["volume_id"] <= cfg.max_volume)]
    return hits.groupby("particle_id").size().to_dict()


def evaluate_toy(candidate_node_lists: Sequence[Sequence[int]],
                 truth: np.ndarray, vivl: np.ndarray,
                 cfg: PipelineConfig) -> EfficiencyReport:
    """Reconstruction efficiency on a toy event (1 hit == 1 node).

    Same matching rules as the TrackML evaluator / the reference
    (reconstruction_efficiency.py:66,155-187,213-218): reference track =
    particle with >= eval_min_layers distinct layers; matched when the
    candidate's majority particle contributes >= 50% of that particle's
    hits and track & particle purity are >= eval_purity_cut, with the
    double-count guard.  The pT cut does not apply (toy tracks carry no
    momentum).  This is the non-vacuous efficiency workload: the committed
    TrackML network yields 0 reconstructable tracks under every exposed
    reference configuration (BASELINE.md), while toy events reconstruct.
    """
    truth = np.asarray(truth)
    vivl = np.asarray(vivl)
    refs: Dict[int, int] = {}
    for pid in np.unique(truth):
        if pid < 0:
            continue
        sel = truth == pid
        layers = {(int(v), int(l)) for v, l in vivl[sel]}
        if len(layers) >= cfg.eval_min_layers:
            refs[int(pid)] = int(sel.sum())

    reconstructed = set()
    track_pur, particle_pur = [], []
    for nodes in candidate_node_lists:
        pids = [int(truth[int(n)]) for n in nodes]
        if not pids:
            continue
        freq = Counter(pids)
        pid = max(freq, key=freq.get)
        n_good = freq[pid]
        if pid not in refs or n_good < 0.5 * refs[pid]:
            continue
        tp = n_good / len(pids)
        pp = n_good / refs[pid]
        if tp >= cfg.eval_purity_cut and pp >= cfg.eval_purity_cut:
            if pid not in reconstructed:
                reconstructed.add(pid)
                track_pur.append(tp)
                particle_pur.append(pp)
    return EfficiencyReport(
        num_reference=len(refs), num_reconstructed=len(reconstructed),
        efficiency_pct=100.0 * len(reconstructed) / max(len(refs), 1),
        track_purities=np.asarray(track_pur),
        particle_purities=np.asarray(particle_pur))


def evaluate(candidate_node_lists: Sequence[np.ndarray], host: HostEvent,
             particles_csv: str, truth_csv: str,
             cfg: PipelineConfig) -> EfficiencyReport:
    refs = reference_tracks(particles_csv, truth_csv, cfg)
    nhits_region = hits_in_region(truth_csv, cfg)

    reconstructed = set()
    track_pur, particle_pur = [], []
    for nodes in candidate_node_lists:
        pids: List[int] = []
        for n in nodes:
            hp = host.hit_particle_ids[int(n)]
            if hp is not None:
                pids.extend(int(p) for p in hp)
        if not pids:
            continue
        freq = Counter(pids)
        pid = max(freq, key=freq.get)
        n_good = freq[pid]
        if pid not in refs:
            continue
        if n_good < 0.5 * len(refs[pid]):
            continue
        track_purity = n_good / len(pids)
        particle_purity = n_good / nhits_region.get(pid, n_good)
        if track_purity >= cfg.eval_purity_cut and particle_purity >= cfg.eval_purity_cut:
            if pid not in reconstructed:
                reconstructed.add(pid)
                track_pur.append(track_purity)
                particle_pur.append(particle_purity)

    num_ref = len(refs)
    num_rec = len(reconstructed)
    return EfficiencyReport(
        num_reference=num_ref, num_reconstructed=num_rec,
        efficiency_pct=100.0 * num_rec / max(num_ref, 1),
        track_purities=np.asarray(track_pur),
        particle_purities=np.asarray(particle_pur))
