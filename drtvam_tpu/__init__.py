"""drtvam_tpu — a differentiable tomographic renderer in JAX for
volumetric additive manufacturing (TVAM) pattern optimization.

A from-scratch JAX/XLA/Pallas framework with the capabilities of Dr.TVAM
("Inverse Rendering for Tomographic Volumetric Additive Manufacturing",
SIGGRAPH Asia 2024). The compute path is pure JAX (jit/vmap/lax, plus
Pallas kernels through Triton for the GPU's backprojection); scenes are
pytrees; gradients are hand-derived adjoints registered through
jax.custom_vjp.

Layer map (a rebuild, not a port):
  core/     — transforms, warp sampling, counter-based RNG
  ops/      — intersection kernels, fresnel, DDA dose estimators, the
              wavefront path-tracing march (+ custom_vjp adjoint), fast
              gather-based ballistic engine and its GPU kernels
  models/   — domain model: projectors, motion, vials, sensors, scene
  opt/      — losses, L-BFGS (incl. linear variant), optimize() driver
  parallel/ — device-mesh sharding of the ray/angle space, psum dose
  utils/    — IO (EXR/NPY/NPZ), metrics, mesh generation

User-extensible registries mirror the reference's plugin system
(reference: src/drtvam/__init__.py:32-51).
"""

__version__ = "0.1.0"

# --- extension registries -------------------------------------------------
# Users register custom geometries / motions / losses / phase functions by
# name, mirroring drtvam's register_geometry/register_motion/register_loss.

from .models.geometry import geometries, register_geometry
from .models.motion import motions, register_motion
from .opt.loss import losses, register_loss
from .ops.medium import phase_functions, register_phase

__all__ = [
    "geometries", "register_geometry",
    "motions", "register_motion",
    "losses", "register_loss",
    "phase_functions", "register_phase",
]
