"""The differentiable-rendering toolkit (`tpusky/ad/`):

- `integrators`: render_primal, render_forward (forward mode),
  render_backward (reverse mode) and the AD integrator aliases;
- `optimizers`: SGD and Adam (masked and uniform variants);
- `largesteps`: LargeSteps' preconditioned mesh optimisation;
- `projective`: boundary-term gradients of visibility discontinuities
  (silhouettes, directional shadows, indirect blockers), with
  `guiding`'s boundary-sample guiding;
- `recovery`: the sunsky recovery recipe of the benchmark.
"""

from .integrators import (AD_INTEGRATOR_ALIASES, render_backward,
                          render_forward, render_primal)
from .largesteps import LargeSteps, mesh_laplacian_edges
from .optimizers import SGD, Adam, Optimizer
from .projective import (boundary_grad, primary_boundary_grad,
                         shadow_boundary_grad)

__all__ = [
    "render_primal", "render_forward", "render_backward",
    "AD_INTEGRATOR_ALIASES", "SGD", "Adam", "Optimizer",
    "LargeSteps", "mesh_laplacian_edges",
    "boundary_grad", "primary_boundary_grad", "shadow_boundary_grad",
]
