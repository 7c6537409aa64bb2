"""Recreate the reference-pipeline baseline run from a reference checkout.

The parity suite (tests/test_reference_artifacts.py, tools/
validate_vs_reference.py) compares this framework's device states against
the *actual* reference pipeline's pickled outputs.  The reference cannot
run unmodified on this machine, so this script builds a runnable copy:

  1. copies the reference checkout (--reference) -> DEST,
  2. installs a `filterpy` shim with filterpy-1.4.5-identical
     KalmanFilter.predict/update semantics (including the scalar-Q
     elementwise broadcast the reference relies on at
     extract_track_candidates.py:304 `g.Q = var_ms`),
  3. installs a `sitecustomize` that restores nx.read_gpickle /
     nx.write_gpickle (removed in networkx 3.x),
  4. patches the copied sources (never the checkout itself):
       - event_conversion.py: skip helper.load_save_truth — its raw
         inputs (truth.csv/particles.csv/hits.csv) are absent from the
         checkout; the aggregated full-mapping CSV it would produce is
         committed and read directly (helper.py:548-581),
       - clustering.py get_smallest_dist_idx (clustering.py:114-124):
         guard the zero-size reduction when every pairwise distance is 0
         and truncate duplicate-minimum index sets to the first row-major
         pair — the two latent crashes at full-event scale (BASELINE.md);
         both guards mirror this framework's masked handling
         (ops/clustering.py argmin over a matrix with zeros masked to inf)
         and are no-ops at volume 7,
       - run script: point EVENT_NETWORK at minCurv_0.3_134 (the _800
         edges CSV is a missing large blob, .MISSING_LARGE_BLOBS:2),
  5. optionally runs the full pipeline (--run), recording per-stage
     seconds the same way the reference's bash `$SECONDS` does.

Usage:
  python tools/make_ref_baseline.py --reference DIR --dest DIR [--run]
      [--volumes 7 7]
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import time

FILTERPY_KALMAN = '''\
"""filterpy.kalman shim: KalmanFilter with filterpy-1.4.5 semantics."""
import sys
import numpy as np
from copy import deepcopy


def reshape_z(z, dim_z, ndim):
    z = np.atleast_2d(z)
    if z.shape[1] == dim_z:
        z = z.T
    if z.shape != (dim_z, 1):
        raise ValueError("z must be convertible to shape ({}, 1)".format(dim_z))
    if ndim == 1:
        z = z.T[0]
    if ndim == 0:
        z = z[0, 0]
    return z


class KalmanFilter(object):
    def __init__(self, dim_x, dim_z, dim_u=0):
        self.dim_x = dim_x
        self.dim_z = dim_z
        self.dim_u = dim_u
        self.x = np.zeros((dim_x, 1))
        self.P = np.eye(dim_x)
        self.Q = np.eye(dim_x)
        self.B = None
        self.F = np.eye(dim_x)
        self.H = np.zeros((dim_z, dim_x))
        self.R = np.eye(dim_z)
        self._alpha_sq = 1.0
        self.z = np.array([[None] * dim_z]).T
        self.K = np.zeros((dim_x, dim_z))
        self.y = np.zeros((dim_z, 1))
        self.S = np.zeros((dim_z, dim_z))
        self.SI = np.zeros((dim_z, dim_z))
        self._I = np.eye(dim_x)
        self.x_prior = self.x.copy()
        self.P_prior = self.P.copy()
        self.x_post = self.x.copy()
        self.P_post = self.P.copy()
        self.inv = np.linalg.inv

    def predict(self, u=None, B=None, F=None, Q=None):
        if B is None:
            B = self.B
        if F is None:
            F = self.F
        if Q is None:
            Q = self.Q          # NOTE: scalar self.Q stays scalar and
        elif np.isscalar(Q):    # broadcasts elementwise below — the quirk
            Q = np.eye(self.dim_x) * Q
        if B is not None and u is not None:
            self.x = np.dot(F, self.x) + np.dot(B, u)
        else:
            self.x = np.dot(F, self.x)
        self.P = self._alpha_sq * np.dot(np.dot(F, self.P), F.T) + Q
        self.x_prior = self.x.copy()
        self.P_prior = self.P.copy()

    def update(self, z, R=None, H=None):
        if z is None:
            self.z = np.array([[None] * self.dim_z]).T
            self.x_post = self.x.copy()
            self.P_post = self.P.copy()
            self.y = np.zeros((self.dim_z, 1))
            return
        if R is None:
            R = self.R
        if np.isscalar(R):
            R = np.eye(self.dim_z) * R
        if H is None:
            z = reshape_z(z, self.dim_z, self.x.ndim)
            H = self.H
        self.y = z - np.dot(H, self.x)
        PHT = np.dot(self.P, H.T)
        self.S = np.dot(H, PHT) + R
        self.SI = self.inv(self.S)
        self.K = np.dot(PHT, self.SI)
        self.x = self.x + np.dot(self.K, self.y)
        I_KH = self._I - np.dot(self.K, H)
        self.P = np.dot(np.dot(I_KH, self.P), I_KH.T) + np.dot(
            np.dot(self.K, R), self.K.T)
        self.z = deepcopy(z)
        self.x_post = self.x.copy()
        self.P_post = self.P.copy()


def update(x, P, z, R, H=None, return_all=False):
    """Functional update (imported, unused, by extrapolate_merged_states)."""
    f = KalmanFilter(dim_x=x.shape[0], dim_z=np.atleast_1d(z).shape[0])
    f.x, f.P, f.R = x, P, R
    if H is not None:
        f.H = H
    f.update(z)
    return (f.x, f.P) if not return_all else (f.x, f.P, f.y, f.K, f.S, None)
'''

FILTERPY_COMMON = '''\
"""filterpy.common shim: Saver (records attributes per save())."""
import copy
import numpy as np


class Saver(object):
    def __init__(self, kf, save_current=False, skip_private=True,
                 skip_callable=True, ignore=()):
        self._kf = kf
        self._saves = []
        if save_current:
            self.save()

    def save(self):
        snap = {}
        for k, v in vars(self._kf).items():
            if k.startswith("_") or callable(v):
                continue
            snap[k] = copy.deepcopy(v) if isinstance(v, np.ndarray) else v
        self._saves.append(snap)

    def __getattr__(self, name):
        saves = object.__getattribute__(self, "_saves")
        if saves and name in saves[0]:
            return [s[name] for s in saves]
        raise AttributeError(name)
'''

SITECUSTOMIZE = '''\
"""Restore the networkx<3 gpickle API the reference uses."""
import pickle

import networkx as nx

if not hasattr(nx, "read_gpickle"):
    def read_gpickle(path):
        with open(path, "rb") as f:
            return pickle.load(f)

    def write_gpickle(G, path, protocol=pickle.HIGHEST_PROTOCOL):
        with open(path, "wb") as f:
            pickle.dump(G, f, protocol)

    nx.read_gpickle = read_gpickle
    nx.write_gpickle = write_gpickle
'''

# (old, new, file) exact-string source patches; every miss is fatal.
PATCHES = [
    # Raw TrackML truth inputs are absent; the aggregated CSV is committed.
    (
        "src/trackml_mod/event_conversion.py",
        "    h.load_save_truth(event_network, event_truth, event_truth_file)",
        "    if os.path.exists(event_truth + \"truth.csv\"):\n"
        "        h.load_save_truth(event_network, event_truth, event_truth_file)",
    ),
    # Zero-size reduction when all pairwise distances are exactly zero
    # (crashes at full-event scale) -> treat as "no compatible pair".
    (
        "src/clustering/clustering.py",
        "        nonzero_dist = distances[np.nonzero(distances)]\n"
        "        smallest_dist = np.min(nonzero_dist)",
        "        nonzero_dist = distances[np.nonzero(distances)]\n"
        "        if nonzero_dist.size == 0:\n"
        "            return np.inf, np.array([0, 1])\n"
        "        smallest_dist = np.min(nonzero_dist)",
    ),
    # Duplicate minima make np.where return >2 indices and np.delete then
    # empties the state arrays -> keep the first row-major pair (same
    # tie-break as ops/clustering.py's flattened argmin).
    (
        "src/clustering/clustering.py",
        "        row, column = np.where(distances==smallest_dist)\n"
        "        idx = np.concatenate((row, column), axis=None)",
        "        row, column = np.where(distances==smallest_dist)\n"
        "        idx = np.concatenate((row[:1], column[:1]), axis=None)",
    ),
    # The _800 network's edges CSV is a missing large blob; _134 is complete.
    (
        "run_gnn_trackml_mod.sh",
        "EVENT_NETWORK=src/trackml_mod/event_network/minCurv_0.3_800",
        "EVENT_NETWORK=src/trackml_mod/event_network/minCurv_0.3_134",
    ),
]


def build(reference: str, dest: str, volumes: tuple[int, int]) -> None:
    if os.path.exists(dest):
        shutil.rmtree(dest)
    print(f"copying {reference} -> {dest}")
    shutil.copytree(reference, dest, ignore=shutil.ignore_patterns(".git"))

    shims = os.path.join(dest, "shims")
    os.makedirs(os.path.join(shims, "filterpy", "kalman"))
    os.makedirs(os.path.join(shims, "filterpy", "common"))
    w = lambda rel, text: open(os.path.join(shims, rel), "w").write(text)
    w("filterpy/__init__.py", "from . import kalman, common\n")
    w("filterpy/kalman/kalman_filter.py", FILTERPY_KALMAN)
    w("filterpy/kalman/__init__.py",
      "from .kalman_filter import KalmanFilter, update, reshape_z\n")
    w("filterpy/common/__init__.py", FILTERPY_COMMON)
    w("sitecustomize.py", SITECUSTOMIZE)

    for rel, old, new in PATCHES:
        path = os.path.join(dest, rel)
        src = open(path).read()
        if old not in src:
            raise SystemExit(f"patch target not found in {rel}:\n{old}")
        open(path, "w").write(src.replace(old, new))
        print(f"patched {rel}")

    lo, hi = volumes
    if (lo, hi) != (7, 7):
        path = os.path.join(dest, "run_gnn_trackml_mod.sh")
        src = open(path).read()
        src = src.replace("min_volume=7", f"min_volume={lo}")
        src = src.replace("max_volume=7", f"max_volume={hi}")
        open(path, "w").write(src)
        print(f"volumes set to {lo}..{hi}")


def run(dest: str) -> int:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(dest, "shims"), os.path.join(dest, "src")])
    env["MPLBACKEND"] = "Agg"
    env.pop("JAX_PLATFORMS", None)
    t0 = time.time()
    proc = subprocess.run(["bash", "run_gnn_trackml_mod.sh"], cwd=dest,
                          env=env)
    print(f"reference pipeline finished in {time.time() - t0:.1f}s "
          f"(rc={proc.returncode})")
    return proc.returncode


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reference", required=True,
                    help="checkout of the reference repository (read only)")
    ap.add_argument("--dest", required=True,
                    help="where to build the runnable copy")
    ap.add_argument("--volumes", nargs=2, type=int, default=[7, 7])
    ap.add_argument("--run", action="store_true",
                    help="run the full pipeline after building the copy")
    args = ap.parse_args()
    build(args.reference, args.dest, tuple(args.volumes))
    if args.run:
        sys.exit(run(args.dest))


if __name__ == "__main__":
    main()
