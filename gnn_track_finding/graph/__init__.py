from gnn_track_finding.graph.state import GraphState  # noqa: F401
