"""Differentiable-rendering entry points, the ADIntegrator surface
(`tpusky/ad/integrators.py`; Mitsuba's `ad/integrators/common.py`:
`render` :46, `render_forward` :112, `render_backward` :164).

A `SceneBundle` renders from a dict of its `traverse()` parameters
(`render(params=...)`), re-deriving the scene from them, so

- `render_primal` renders under `torch.no_grad`;
- `render_forward` is forward-mode AD (`torch.autograd.forward_ad`): the
  parameters go in as dual tensors and the image comes out with its
  tangent J t;
- `render_backward` is reverse mode: `torch.autograd.grad` of the image
  with the adjoint image over the parameters, J^T dL.

`params` defaults to the emitter's parameters (the `emitter.*` entries of
`traverse()`), the reference's `bundle.params`; any other entries of
`traverse()` may be given too (a shape's `to_world`, a reflectance).

Each kernel's route, in both modes, keeps the kernel's primal:

- K4 (the headline frame): the primal is K4's; reverse mode replays the
  wavefront path (K2/K3 forward, K5/K6 backward), forward mode replays
  it under dual tensors (`integrator._Megakernel`);
- K1-K3 and K9-K11: the primal is the kernel's; the backward is K5/K6
  (K7/K8 with the pdf attached) or K12/K13, the tangent forward-mode AD
  of the kernel's plain version in the sunsky state
  (`ops/cuda/sunsky_kernel.py`), as the reference's custom_jvp rules
  evaluate the jnp JVP;
- K14 (meshes): the kernel picks the triangle on detached copies and an
  attached Moller-Trumbore at that triangle carries both modes
  (`render/mesh.py::_attached_hit`).

The boundary terms of visibility discontinuities, which neither mode
sees, are `ad/projective.py`'s. The integrator-name registry is the
loader's `AD_INTEGRATOR_ALIASES`.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.autograd.forward_ad as fwAD

from ..render.loader import AD_INTEGRATOR_ALIASES

__all__ = ["render_primal", "render_forward", "render_backward",
           "AD_INTEGRATOR_ALIASES"]


def _params(bundle, params):
    """The parameters to differentiate: the emitter's by default."""
    if params is None:
        params = {k: v for k, v in bundle.traverse().items()
                  if k.startswith("emitter.")}
    return {k: torch.as_tensor(v, dtype=torch.float32, device=bundle.device)
            for k, v in params.items()}


def render_primal(bundle, params=None, seed: int = 0,
                  spp: Optional[int] = None):
    """The image at `params` (a `traverse()` dict, default the bundle's),
    with gradient tracking off (`common.py:46`, under `dr.suspend_grad`)."""
    with torch.no_grad():
        return bundle.render(seed=seed, spp=spp, params=params)


def render_forward(bundle, params=None, tangents=None, seed: int = 0,
                   spp: Optional[int] = None):
    """Forward-mode differential rendering (`common.py:112`) -> (image,
    J tangents). `tangents` is a dict like `params`; by default every
    entry is all ones (`dr.forward_from` of each parameter)."""
    params = _params(bundle, params)
    if tangents is None:
        tangents = {k: torch.ones_like(v) for k, v in params.items()}
    with fwAD.dual_level():
        duals = {k: fwAD.make_dual(v.detach(), torch.as_tensor(
            tangents[k], dtype=v.dtype, device=v.device).reshape(v.shape))
            for k, v in params.items()}
        img = bundle.render(seed=seed, spp=spp, params=duals)
        primal, tangent = fwAD.unpack_dual(img)
        if tangent is None:                  # nothing moves the image
            tangent = torch.zeros_like(primal)
        return primal.detach().clone(), tangent.clone()


def render_backward(bundle, grad_image, params=None, seed: int = 0,
                    spp: Optional[int] = None):
    """Reverse-mode differential rendering (`common.py:164`): the adjoint
    image dL (dloss/dpixel) -> (image, {name: dL^T dimage/dparam}). The
    backward replays each bounce with the same counter-derived random
    numbers instead of storing them (`prb.py:63-258`'s memory profile)."""
    params = _params(bundle, params)
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    with torch.enable_grad():
        img = bundle.render(seed=seed, spp=spp, params=leaves)
        g = torch.as_tensor(grad_image, dtype=img.dtype, device=img.device)
        grads = torch.autograd.grad(img, list(leaves.values()), g,
                                    allow_unused=True)
    return img.detach(), {k: torch.zeros_like(v) if d is None else d
                          for (k, v), d in zip(leaves.items(), grads)}
