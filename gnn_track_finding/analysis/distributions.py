"""Purity / p-value distribution plots and CSV artifacts.

Re-design of src/extract/purity_distribution.py:1-31,
p_value_distribution.py:1-29 and the pvals.csv writer
(extract_track_candidates.py:487-489): the same histograms and artifacts,
fed from in-memory pipeline results instead of per-iteration CSV relays.
"""

from __future__ import annotations

import os

import numpy as np

from gnn_track_finding.evaluation.efficiency import EfficiencyReport


def save_pvals_csv(candidates, path: str) -> None:
    """pvals.csv with columns pvals_xy, pvals_zr (ref :487-489)."""
    import pandas as pd
    df = pd.DataFrame({
        "pvals_xy": [c.pval_xy for c in candidates],
        "pvals_zr": [c.pval_zr for c in candidates],
    })
    df.to_csv(path)


def save_purity_csvs(report: EfficiencyReport, directory: str) -> None:
    """extracted_track_purities.csv / extracted_particle_purities.csv
    (reconstruction_efficiency.py:190-191)."""
    os.makedirs(directory, exist_ok=True)
    np.savetxt(os.path.join(directory, "extracted_track_purities.csv"),
               report.track_purities, delimiter=",")
    np.savetxt(os.path.join(directory, "extracted_particle_purities.csv"),
               report.particle_purities, delimiter=",")


def plot_purity_distribution(report: EfficiencyReport, out_path: str) -> None:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure(figsize=(8, 6))
    plt.hist(report.track_purities, bins=30, histtype="step",
             label="track purity", align="left", rwidth=0.6)
    plt.hist(report.particle_purities, bins=30, histtype="step",
             label="particle purity", align="left", rwidth=0.6, alpha=0.5)
    plt.ylabel("Frequency")
    plt.xlabel("Purity")
    plt.xlim([-0.05, 1.1])
    plt.legend(loc="best")
    plt.savefig(out_path, dpi=300)
    plt.close()


def plot_pval_distributions(candidates, out_dir: str) -> None:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    for plane, vals in (("xy", [c.pval_xy for c in candidates]),
                        ("zr", [c.pval_zr for c in candidates])):
        fig, ax = plt.subplots()
        ax.hist(vals, bins=50)
        plt.xticks(np.arange(0.0, 1.1, 0.1))
        plt.xlabel(f"p-value distribution from chi2 fit in {plane} plane")
        plt.ylabel("Frequency")
        plt.savefig(os.path.join(out_dir, f"p_value_distribution_{plane}.png"),
                    dpi=300)
        plt.close(fig)


def plot_candidates_xy_zr(g, candidates, out_dir: str,
                          title: str = "Extracted candidates") -> None:
    """Scatter of candidate hits in the xy and zr planes, coloured by
    extraction iteration (plot_all_extracted_candidates.py:1-32,
    helper.py:627-672)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    xyzr = np.asarray(g.xyzr)
    colors = ["#f7c04a", "#2648ad", "#a5e438", "#d16097"]
    for key, (i1, i2), labels in (("xy", (0, 1), ("x [mm]", "y [mm]")),
                                  ("zr", (2, 3), ("z [mm]", "r [mm]"))):
        fig, ax = plt.subplots(figsize=(12, 10))
        seen = set()
        for c in candidates:
            color = colors[(c.iteration - 1) % len(colors)]
            label = f"iteration {c.iteration}"
            ax.plot(xyzr[c.nodes, i1], xyzr[c.nodes, i2], "o-",
                    color=color, markersize=3, linewidth=0.7,
                    label=None if label in seen else label)
            seen.add(label)
        ax.set_xlabel(labels[0])
        ax.set_ylabel(labels[1])
        ax.set_title(title)
        if seen:
            ax.legend(loc="upper left", title="Stage")
        fig.savefig(os.path.join(out_dir, f"subgraphs_{key}.png"), dpi=300)
        plt.close(fig)


def plot_remaining_subgraphs(g, out_dir: str, max_plots: int = 50,
                             node_labels: bool = False,
                             title: str = "") -> int:
    """Per-component xy plots of the remaining (unextracted) network with
    edges coloured by activation (r&d/remaining/plot_remaining_subgraphs.py:
    12-41: one random-colour figure per subgraph, deactivated edges in
    light grey #f2f2f2).  Returns the number of figures written."""
    import random

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    alive = np.asarray(g.node_mask)
    comp = np.asarray(g.component)
    xyzr = np.asarray(g.xyzr)
    src = np.asarray(g.src)
    dst = np.asarray(g.dst)
    act = np.asarray(g.active)
    emask = np.asarray(g.edge_mask)

    by_comp = {}
    for n in np.flatnonzero(alive):
        by_comp.setdefault(int(comp[n]), []).append(int(n))
    edges_of = {}
    for e in np.flatnonzero(emask):
        edges_of.setdefault(int(comp[src[e]]), []).append(e)

    rng = random.Random(0)
    written = 0
    for ci, (label, nodes) in enumerate(sorted(by_comp.items())):
        if written >= max_plots:
            break
        fig, ax = plt.subplots(figsize=(10, 8))
        color = "#" + "".join(rng.choice("0123456789ABCDEF")
                              for _ in range(6))
        for e in edges_of.get(label, []):
            u, v = int(src[e]), int(dst[e])
            ax.plot([xyzr[u, 0], xyzr[v, 0]], [xyzr[u, 1], xyzr[v, 1]],
                    color=(color if act[e] else "#f2f2f2"), alpha=0.75,
                    linewidth=1.0)
        xs = xyzr[nodes, 0]
        ys = xyzr[nodes, 1]
        ax.scatter(xs, ys, s=65, color=color, zorder=3)
        if node_labels:
            for n in nodes:
                ax.annotate(str(n), (xyzr[n, 0], xyzr[n, 1]), fontsize=8)
        ax.set_xlabel("x")
        ax.set_ylabel("y")
        ax.set_title(title or f"remaining subgraph {ci}")
        fig.savefig(os.path.join(out_dir, f"xy_{ci}_subgraphs_trackml_mod.png"),
                    dpi=120)
        plt.close(fig)
        written += 1
    return written
