"""The C++ CSV loader against the pandas parser, on CSVs written from the
committed volume-7 snapshot in the reference's file formats."""

import numpy as np
import pytest

from gnn_track_finding.config import PipelineConfig
from gnn_track_finding.data import native_loader, snapshots, trackml


def _write_event_csvs(tmp_path, name="trackml_v7") -> trackml.TrackMLPaths:
    """nodes / edges / truth CSVs holding exactly the snapshot's arrays."""
    xyzr, vivl, _, pairs, extra, _ = snapshots.load_arrays(name)
    node_ids = np.asarray(extra["node_ids"])
    layer_id = vivl[:, 0].astype(np.int64) * 1000 + vivl[:, 1]
    nodes = tmp_path / "nodes.csv"
    with open(nodes, "w") as f:
        f.write("node_idx,layer_id,x,y,z\n")
        for i in range(len(node_ids)):
            x, y, z = (repr(float(v)) for v in xyzr[i, :3])
            f.write(f"{node_ids[i]},{layer_id[i]},{x},{y},{z}\n")
    edges = tmp_path / "edges.csv"
    with open(edges, "w") as f:
        f.write(f"{len(node_ids)} {len(pairs)}\n")     # count header
        f.write("node2,node1,weight\n")
        for a, b in pairs:
            f.write(f"{node_ids[b]},{node_ids[a]},1.0\n")
    truth = tmp_path / "truth.csv"
    with open(truth, "w") as f:
        f.write("node_idx,hit_id,particle_id,volume_id,layer_id,"
                "module_id,nhits\n")
        for i in range(len(node_ids)):
            hits = extra["hit_ids"][i]
            pids = extra["hit_particle_ids"][i]
            mods = extra["module_ids"][i]
            for j in range(len(hits)):
                mod = mods[min(j, len(mods) - 1)]
                f.write(f"{node_ids[i]},{hits[j]},{pids[j]},{vivl[i, 0]},"
                        f"{vivl[i, 1]},{mod},{len(hits)}\n")
    return trackml.TrackMLPaths(str(nodes), str(edges), str(truth))


def test_native_matches_pandas_on_trackml_event(tmp_path):
    if not native_loader.available():
        pytest.skip("no C++ compiler to build the native loader")
    cfg = PipelineConfig()
    ev = _write_event_csvs(tmp_path)
    nx_, nv, nt, np_, nex = native_loader.load_event_arrays_native(
        ev.nodes_csv, ev.edges_csv, ev.truth_csv,
        cfg.min_volume, cfg.max_volume)
    px, pv, pt, pp, pex = trackml.load_event_arrays(ev, cfg)
    np.testing.assert_allclose(nx_, px)
    assert np.array_equal(nv, pv)
    assert np.array_equal(nt, pt)
    assert np.array_equal(np_, pp)
    assert np.array_equal(nex["node_ids"], pex["node_ids"])
    for i in [0, 5, 100, len(nt) - 1]:
        assert np.array_equal(np.sort(nex["hit_ids"][i]),
                              np.sort(pex["hit_ids"][i]))
        assert np.array_equal(np.sort(np.asarray(nex["module_ids"][i])),
                              np.sort(np.asarray(pex["module_ids"][i])))
    # and both parse back the snapshot they were written from
    xyzr, vivl, truth, pairs, _, _ = snapshots.load_arrays("trackml_v7")
    np.testing.assert_array_equal(nx_[:, :3], xyzr[:, :3])
    np.testing.assert_allclose(nx_, xyzr, rtol=1e-15)
    assert np.array_equal(nv, vivl)
    assert np.array_equal(nt, truth)
    assert np.array_equal(np_, pairs)
