"""slam_plus_plus_tpu — an accelerator-native incremental sparse nonlinear
least-squares framework for factor-graph SLAM / bundle adjustment.

Re-imagines the capabilities of SLAM++ (martin-velas/SLAM_plus_plus; IJRR 2017)
as a JAX/XLA/Pallas framework:

  * the reference's fixed-block-size (FBS) compile-time BLAS specialization
    (reference: include/slam/BlockMatrixFBS.h) becomes *batched dense block
    kernels* — same-sized blocks stacked into ``[N, B, B]`` arrays and driven
    through batched kernels with ``vmap``/Pallas;
  * its OpenMP reduction plans (reference: include/slam/NonlinearSolver_Lambda_Base.h)
    become deterministic ``segment_sum`` scatter assembly;
  * its CUDA Schur path (reference: src/slam/LinearSolver_Schur_GPU.cpp) becomes
    a fully on-device Schur-complement pipeline;
  * its single-node OpenMP parallelism becomes SPMD over a ``jax.sharding.Mesh``.

Public API (stable):
    load_graph / parse_g2o         — dataset ingestion (g2o dialect superset)
    GraphSystem                    — typed columnar factor-graph container
    optimize / GaussNewton / LevenbergMarquardt / Dogleg / FastL
    marginals                      — covariance recovery
"""

from slam_plus_plus_tpu.config import SolverConfig, default_dtype
from slam_plus_plus_tpu.graph.system import GraphSystem
from slam_plus_plus_tpu.io.parser import parse_g2o, peek_dataset

__version__ = "0.1.0"

__all__ = [
    "SolverConfig",
    "default_dtype",
    "GraphSystem",
    "parse_g2o",
    "peek_dataset",
    "__version__",
]
