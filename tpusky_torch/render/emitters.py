"""Emitters: the environment (sunsky, constant, uniform), spot lights and
shape-attached area lights (`tpusky/render/emitters.py`).

Directions here are world-space; the sunsky state's local frame is
reached through the scene's `env_to_world` rotation. The environment is
dispatched on its type, one per scene. The argument order is the
reference's (`wavelengths`, then `mode`, then `pdf_detached`); in
spectral mode every call takes the lanes' hero `wavelengths` (..., W) in
nm. `plain=True` runs the sunsky model's plain versions instead of
kernels K1-K3 (K9-K11 in spectral mode), the reference the kernels and
the megakernel are held against. A `ConstantEnv` in spectral mode needs
the reference's rgb2spec upsampling, which is not ported.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models.sunsky import model as sunsky
from ..ops import warp
from ..ops.math import mat3_apply, mat3_apply_t
from .shapes import sample_position


class ConstantEnv(NamedTuple):
    """Uniform environment radiance from an RGB colour (`constant.cpp`
    with an srgb_d65 radiance)."""
    radiance: torch.Tensor       # (C,)


class UniformEnv(NamedTuple):
    """Constant environment with a flat spectrum (`uniform.cpp` on
    `constant.cpp`): in spectral mode the channels' mean holds at every
    wavelength, with no upsampling and no illuminant."""
    radiance: torch.Tensor       # (C,) equal channels


def _flat(env, d_world, wavelengths):
    """The radiance of a ConstantEnv or UniformEnv toward d_world."""
    if wavelengths is not None:
        if isinstance(env, ConstantEnv):
            raise NotImplementedError(
                "a ConstantEnv in spectral mode needs ops/rgb2spec.py, "
                "which is not ported")
        return env.radiance.mean().expand(wavelengths.shape)
    return env.radiance.expand(d_world.shape[:-1] + env.radiance.shape)


def _check(env):
    if not isinstance(env, (sunsky.SunskyState, ConstantEnv, UniformEnv)):
        raise NotImplementedError(f"environment {type(env).__name__}")


def env_eval(env, d_world, env_to_world, wavelengths=None, mode="rgb",
             plain=False):
    """Environment radiance toward world direction d (pointing at the sky)."""
    _check(env)
    if isinstance(env, sunsky.SunskyState):
        return sunsky.eval(env, mat3_apply_t(env_to_world, d_world),
                           wavelengths, mode, plain=plain)
    return _flat(env, d_world, wavelengths)


def env_pdf_direction(env, env_to_world, d_world):
    """Solid-angle pdf of `env_sample_direction` toward d_world."""
    _check(env)
    if isinstance(env, sunsky.SunskyState):
        return sunsky.pdf_direction(env, mat3_apply_t(env_to_world, d_world))
    return torch.full(d_world.shape[:-1], warp.INV_FOUR_PI,
                      device=d_world.device)


def env_sample_direction(env, env_to_world, sample2):
    """Importance-sample a world direction toward the environment ->
    (d_world, pdf): the sunsky's TGMM + sun-cone mixture, or the uniform
    sphere for a constant environment."""
    _check(env)
    if isinstance(env, sunsky.SunskyState):
        d_local, pdf = sunsky.sample_direction(env, sample2)
        return mat3_apply(env_to_world, d_local), pdf
    d = warp.square_to_uniform_sphere(sample2)
    return d, torch.full(d.shape[:-1], warp.INV_FOUR_PI, device=d.device)


def env_eval_pdf(env, d_world, env_to_world, wavelengths=None, mode="rgb",
                 pdf_detached=False, plain=False):
    """(radiance, solid-angle pdf) toward d_world: the emitter-hit MIS
    block (kernel K2, or K10 in spectral mode, for CUDA tensors)."""
    _check(env)
    if isinstance(env, sunsky.SunskyState):
        return sunsky.eval_pdf(env, mat3_apply_t(env_to_world, d_world),
                               wavelengths, mode, pdf_detached=pdf_detached,
                               plain=plain)
    return (_flat(env, d_world, wavelengths),
            env_pdf_direction(env, env_to_world, d_world))


def env_sample_eval(env, env_to_world, sample2, wavelengths=None,
                    mode="rgb", pdf_detached=False, plain=False):
    """Importance-sample a world direction and evaluate its radiance + pdf:
    the NEE block (kernel K3, or K11 in spectral mode, for CUDA tensors).
    The direction comes back detached (sample placement)."""
    _check(env)
    if isinstance(env, sunsky.SunskyState):
        d_local, rad, pdf = sunsky.sample_eval(env, sample2, wavelengths,
                                               mode,
                                               pdf_detached=pdf_detached,
                                               plain=plain)
        return mat3_apply(env_to_world, d_local).detach(), rad, pdf
    d, pdf = env_sample_direction(env, env_to_world, sample2)
    return d, _flat(env, d, wavelengths), pdf


# ---------------------------------------------------------------------------
# Delta position emitters: spot / projector
# ---------------------------------------------------------------------------


class SpotLight(NamedTuple):
    """Spot light with an optional projected texture (`spot.cpp`: a cone
    with a linear falloff between `cos_beam` and `cos_cutoff`;
    `projector.cpp`: cos_beam == cos_cutoff and a texture)."""
    position: torch.Tensor     # (3,)
    direction: torch.Tensor    # (3,) unit, beam axis
    frame_x: torch.Tensor      # (3,) beam-local frame for the texture's uv
    frame_y: torch.Tensor      # (3,)
    intensity: torch.Tensor    # (C,) radiant intensity at the beam centre
    cos_cutoff: torch.Tensor   # () outer cone angle cosine (0 outside)
    cos_beam: torch.Tensor     # () inner cone angle cosine (1 inside)
    texture: Optional[torch.Tensor] = None  # (Th, Tw, C) projected pattern


def make_spot(position, direction, intensity, cutoff_angle_deg=20.0,
              beam_width_deg=None, texture=None, device="cuda") -> SpotLight:
    """The reference's `make_spot` (`tpusky/render/emitters.py:186-205`):
    the beam frame built on the host, the beam width 3/4 of the cutoff by
    default."""
    d = np.asarray(direction, np.float32)
    d = d / np.linalg.norm(d)
    up = (np.array([0.0, 0.0, 1.0], np.float32)
          if abs(d[2]) < 0.999 else np.array([1.0, 0.0, 0.0], np.float32))
    fx = np.cross(up, d)
    fx = fx / np.linalg.norm(fx)
    fy = np.cross(d, fx)
    if beam_width_deg is None:
        beam_width_deg = cutoff_angle_deg * 0.75

    def f32(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)
    return SpotLight(
        f32(position), f32(d), f32(fx), f32(fy),
        f32(np.atleast_1d(np.asarray(intensity, np.float32))),
        f32(np.cos(np.deg2rad(cutoff_angle_deg))),
        f32(np.cos(np.deg2rad(beam_width_deg))),
        None if texture is None else f32(texture))


def spot_falloff(light: SpotLight, d_out):
    """Angular falloff times the texture toward world direction `d_out`
    (from the light) -> (..., C). The texture is a nearest-texel lookup in
    the beam frame, spanned by the cutoff angle."""
    cos_t = (d_out * light.direction).sum(-1)
    ramp = ((cos_t - light.cos_cutoff)
            / (light.cos_beam - light.cos_cutoff).clamp(min=1e-6))
    falloff = ramp.clamp(0.0, 1.0)
    falloff = torch.where(cos_t <= light.cos_cutoff, 0.0, falloff)
    falloff = torch.where(cos_t >= light.cos_beam, 1.0, falloff)
    out = falloff[..., None] * light.intensity
    if light.texture is not None:
        x = (d_out * light.frame_x).sum(-1)
        y = (d_out * light.frame_y).sum(-1)
        z = cos_t.clamp(min=1e-6)
        tan_half = (torch.sqrt((1.0 - light.cos_cutoff ** 2).clamp(min=1e-12))
                    / light.cos_cutoff.clamp(min=1e-6))
        u = 0.5 * (x / (z * tan_half) + 1.0)
        v = 0.5 * (y / (z * tan_half) + 1.0)
        th, tw = light.texture.shape[:2]
        xi = (u * tw).to(torch.int64).clamp(0, tw - 1)
        yi = (v * th).to(torch.int64).clamp(0, th - 1)
        texel = light.texture.reshape(-1, light.texture.shape[-1])[
            yi * tw + xi]
        inside = (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (v <= 1.0)
        out = out * torch.where(inside[..., None], texel, 0.0)
    return out


# ---------------------------------------------------------------------------
# Area emitters (shape-attached)
# ---------------------------------------------------------------------------


def area_sample_direction(scene, p_ref, u2, u1):
    """Sample a direction toward one of the scene's area emitters: an
    emitter shape picked uniformly by u1 (`scene.cpp:311`), a point on it
    uniform in area, the pdf in solid angle -> (d, dist, pdf_solid,
    radiance (..., C), n_emit, shape_idx), pdf 0 where the sampled point
    faces away."""
    n_area = scene.area_emitter_shapes.shape[0]
    pick = (u1 * n_area).to(torch.int64).clamp(0, n_area - 1)
    shape_idx = scene.area_emitter_shapes[pick]
    p_emit, n_emit, pdf_area = sample_position(scene.shapes, shape_idx, u2)
    to_emit = p_emit - p_ref
    dist2 = (to_emit * to_emit).sum(-1)
    dist = torch.sqrt(dist2.clamp(min=1e-12))
    d = to_emit / dist[..., None]
    cos_emit = (n_emit * -d).sum(-1)
    pdf_solid = torch.where(cos_emit > 1e-6,
                            pdf_area * dist2 / cos_emit.clamp(min=1e-6)
                            / n_area, 0.0)
    return (d, dist, pdf_solid, scene.area_radiance[shape_idx], n_emit,
            shape_idx)


def area_pdf_direction(scene, p_ref, p_hit, n_hit, shape_idx):
    """Solid-angle pdf with which `area_sample_direction` would reach
    shape `shape_idx` at `p_hit` (MIS of emitter hits, `scene.cpp:351`)."""
    n_area = scene.area_emitter_shapes.shape[0]
    to_hit = p_hit - p_ref
    dist2 = (to_hit * to_hit).sum(-1)
    d = to_hit / torch.sqrt(dist2.clamp(min=1e-12))[..., None]
    cos_emit = (n_hit * -d).sum(-1)
    pdf_area = 1.0 / scene.shapes.area[shape_idx]
    is_emitter = scene.shapes.emitter_idx[shape_idx] >= 0
    return torch.where(is_emitter & (cos_emit > 1e-6),
                       pdf_area * dist2 / cos_emit.clamp(min=1e-6) / n_area,
                       0.0)
