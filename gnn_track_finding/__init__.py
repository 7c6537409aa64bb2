"""gnn_track_finding — GPU track-finding framework.

A ground-up JAX/XLA re-design of the capabilities of
nishalad95/GNN-track-finding (the reference): a
Gaussian-mixture Kalman-filter message-passing pipeline over detector hit
graphs, rebuilt as jitted transforms of a single padded struct-of-arrays
graph state resident on device.

Layer map (mirrors SURVEY.md section 1, re-architected for one device-
resident program):

  L0 data model     -> graph.state.GraphState (padded SoA pytree)
  L1 graph runtime  -> graph.build / graph.cca / ops.linalg
  L2 pipeline ops   -> ops.seeding / ops.priors / ops.clustering /
                       ops.extrapolate / ops.extract / ops.metadata
  L3 orchestration  -> models.pipeline (lax-driven iteration schedule)
  L4 evaluation     -> evaluation.efficiency / evaluation.metrics
  L5 calibration    -> calib (KL training data -> decision boundary -> LUT)
  L6 alternatives   -> graph.cca (label propagation == tag_propagation)
"""

__version__ = "0.1.0"

from gnn_track_finding.config import PipelineConfig  # noqa: F401
