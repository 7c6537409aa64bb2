"""Committed event snapshots: loaded by name, checked by content hash."""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest

from gnn_track_finding.config import PipelineConfig
from gnn_track_finding.data import snapshots, trackml


@pytest.mark.parametrize("name, nodes, pairs", [
    ("trackml_v7", 8748, 7383),
    ("trackml_full", 55701, 165472),
])
def test_snapshot_arrays_by_name(name, nodes, pairs):
    xyzr, vivl, truth, pr, extra, pre = snapshots.load_arrays(name)
    assert xyzr.shape == (nodes, 4) and vivl.shape == (nodes, 2)
    assert truth.shape == (nodes,) and pr.shape == (pairs, 2)
    assert len(extra["hit_ids"]) == nodes
    assert pre["mirror"].shape == (2 * pairs,)
    snap = snapshots.SNAPSHOTS[name]
    vols = np.unique(vivl[:, 0])
    assert vols.min() >= snap.min_volume and vols.max() <= snap.max_volume
    assert snapshots.for_volumes(snap.min_volume, snap.max_volume) == name


def test_snapshot_hash_mismatch_raises(tmp_path, monkeypatch):
    bad = tmp_path / "trackml_v7.npz"
    shutil.copy(snapshots.path("trackml_v7"), bad)
    with open(bad, "r+b") as f:            # flip one byte of the payload
        f.seek(os.path.getsize(bad) // 2)
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0xFF]))
    monkeypatch.setattr(snapshots, "_DIR", str(tmp_path))
    with pytest.raises(ValueError, match="sha256"):
        snapshots.load_arrays("trackml_v7")


def test_unknown_snapshot_and_volume_window():
    with pytest.raises(KeyError, match="unknown snapshot"):
        snapshots.load_arrays("trackml_v9")
    with pytest.raises(KeyError, match="no snapshot covers"):
        snapshots.for_volumes(9, 9)
    with pytest.raises(ValueError, match="holds volumes 7-7"):
        snapshots.load_event("trackml_v7",
                             PipelineConfig(min_volume=7, max_volume=14))


def test_trackml_load_event_takes_a_snapshot_name():
    cfg = PipelineConfig()
    g, host = trackml.load_event("trackml_v7", cfg, dtype=jnp.float32,
                                 with_tracker=False)
    assert g.n_nodes == 8748 and g.n_edges == 2 * 7383
    assert g.dtype == jnp.float32
    assert len(host.node_ids) == 8748
