"""Global configuration: the device policy and solver settings.

The reference is double-precision everywhere (C++ ``double``).  Policy:

  * on CPU (tests, verification): float64 when x64 is on, bit-matching a
    NumPy/SciPy oracle;
  * on the GPU: float32 compute at full f32 matmul precision (no TF32),
    with float64-equivalent accuracy recovered through iterative
    refinement of the linear solves.

``device_policy()`` is the one place that keys behaviour on the backend;
every array-creating entry point takes an optional dtype override.

Reference analogue: the three-tier config system of SLAM++ (CMake defines /
ConfigSolvers.h / TCommandLineArgs — reference include/slam/ConfigSolvers.h:24,
include/slam_app/Main.h:1645) collapses here into one dataclass.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp


def x64_enabled() -> bool:
    return bool(jax.config.read("jax_enable_x64"))


@dataclasses.dataclass(frozen=True)
class DevicePolicy:
    """What the solvers do differently per backend."""

    platform: str                     # "cpu" | "gpu"
    dtype: object                     # compute dtype of the solve path
    dense_limit: int                  # scalar dims up to which the direct
                                      # dense Cholesky path is taken
    matmul_precision: Optional[str]   # jax_default_matmul_precision, or
                                      # None for the backend's default


def device_policy(platform: Optional[str] = None) -> DevicePolicy:
    """The device policy of ``platform`` (default: JAX's default backend).

    The GPU dense limit was chosen by timing the manhattan3500 ``-nsp 1``
    lambda replay on an H100 at 6000 and 20000 (CHANGES.md)."""
    if platform is None:
        platform = jax.default_backend()
    if platform == "cpu":
        return DevicePolicy("cpu",
                            jnp.float64 if x64_enabled() else jnp.float32,
                            dense_limit=6000, matmul_precision=None)
    if platform == "gpu":
        # f32 products must not run in TF32: the solve path is checked
        # against f64 goldens at full f32 precision
        return DevicePolicy("gpu", jnp.float32, dense_limit=6000,
                            matmul_precision="highest")
    raise ValueError(f"no device policy for platform {platform!r} "
                     "(known: cpu, gpu)")


def apply_matmul_precision(policy: Optional[DevicePolicy] = None) -> None:
    """Set JAX's default matmul precision to the policy's.  Solvers call
    this before tracing (Assembler construction), so every f32 product on
    the solve path follows the policy."""
    prec = (policy or device_policy()).matmul_precision
    if prec is not None and jax.config.jax_default_matmul_precision != prec:
        jax.config.update("jax_default_matmul_precision", prec)


def default_dtype(platform: Optional[str] = None):
    """The device policy's compute dtype."""
    return device_policy(platform).dtype


@dataclasses.dataclass(frozen=True)
class IncrementalPolicy:
    """When to run nonlinear iterations during incremental operation.

    Reference analogue: TIncrementalSolveSetting / the fluent
    ``solve::Nonlinear(frequency::Every(N))`` API
    (reference include/slam/IncrementalPolicy.h:45-70,172).
    """

    every_n_vertices: int = 0        # 0 = never (batch mode)
    max_iterations: int = 5
    dx_threshold: float = 1e-2       # reference default f_nonlinear_solve_error_threshold = .01
    # batch-final settings
    final_max_iterations: int = 5
    final_dx_threshold: float = 1e-2


@dataclasses.dataclass(frozen=True)
class MarginalsPolicy:
    """Which part of the covariance to maintain, and how often.

    Reference analogue: TMarginalsComputationPolicy + EBlockMatrixPart
    (reference include/slam/IncrementalPolicy.h:366-372,398).
    """

    enabled: bool = False
    part: str = "diagonal"           # diagonal | last_column | full
    increment_every: int = 1
    relinearize_update: bool = True  # allow incremental omega-updates


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    solver: str = "lambda"           # a | lambda | lambda_lm | lambda_dl | fast_l
    linear_solver: str = "auto"      # auto | dense | block_cholesky | schur | scipy
    use_schur: bool = False
    # landmark-class elimination policy: "auto" splits off the landmark
    # class for Schur only when the reduced (pose/camera) system is small
    # enough for the dense path — the reference's own default applies
    # Schur on request (-us) and solves many-pose landmark SLAM with a
    # fill-reducing ordering over ALL variables (unit_tests.sh cityTrees10k
    # row has no -us).  "off" always mixes; "on" always splits.
    schur_split: str = "auto"
    dtype: Optional[object] = None   # None = default_dtype()
    use_pallas: str = "auto"         # auto | on | off — fused GPU P2C kernel
    # "uniform": sort + pad observation edges into a per-landmark [Nl, M]
    # layout at build time so every landmark-side reduction and the Schur
    # panel build become pure reshapes instead of gathers/scatters of O(E)
    # rows.  "auto" enables it for batch landmark
    # problems when padding inflates the edge count <= 1.5x; "flat" keeps
    # parse order (required by the incremental prefix-masking engines).
    edge_layout: str = "auto"        # auto | uniform | flat
    refine_iterations: int = 2       # iterative-refinement sweeps for f32 solves
    incremental: IncrementalPolicy = dataclasses.field(default_factory=IncrementalPolicy)
    marginals: MarginalsPolicy = dataclasses.field(default_factory=MarginalsPolicy)
    damping_init: float = 0.0        # LM initial damping; 0 = derive from diagonal
    dogleg_radius: float = 1.0
    verbose: bool = False
    # per-edge-type robust loss overrides: {edge_type_name: (loss, scale)}
    # with loss in robust.losses.LOSSES; overrides the type registry's
    # defaults (reference: robust mixin template parameters,
    # include/slam/RobustUtils.h:368-502).  {"*": (...)} applies to every
    # robust-enabled edge type.
    robust_overrides: Optional[dict] = None

    def resolved_dtype(self):
        return self.dtype if self.dtype is not None else default_dtype()
