"""Emitters: the environment (sunsky, constant, uniform, a lat-long
bitmap), spot lights and shape-attached area lights
(`tpusky/render/emitters.py`).

Directions here are world-space; the sunsky state's local frame is
reached through the scene's `env_to_world` rotation. The environment is
dispatched on its type, one per scene. The argument order is the
reference's (`wavelengths`, then `mode`, then `pdf_detached`); in
spectral mode every call takes the lanes' hero `wavelengths` (..., W) in
nm. `plain=True` runs the sunsky model's plain versions instead of
kernels K1-K3 (K9-K11 in spectral mode), the reference the kernels and
the megakernel are held against. In spectral mode a `ConstantEnv`'s
RGB and an envmap's texels are upsampled with rgb2spec (`ops/rgb2spec`,
the emitter convention: times D65); an envmap without per-texel spectra
shows its channels' mean at every wavelength, as the reference's does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models.sunsky import model as sunsky
from ..ops import warp
from ..ops.distr2d import (Bilinear2D, bilinear_pdf, bilinear_sample,
                           make_bilinear_2d)
from ..ops.math import PI, mat3_apply, mat3_apply_t, safe_acos
from ..ops.rgb2spec import (emitter_coeffs, eval_emitter_coeff_spectrum,
                            fit_sigmoid_coeffs_torch)
from .shapes import sample_position


class ConstantEnv(NamedTuple):
    """Uniform environment radiance from an RGB colour (`constant.cpp`
    with an srgb_d65 radiance): in spectral mode its rgb2spec spectrum
    times D65, from `coeff` where a render fitted it (`scene.
    with_emitter_coeffs`), else fitted at the call."""
    radiance: torch.Tensor       # (C,)
    # internal: (4,) rgb2spec coefficients, set by `with_emitter_coeffs`
    coeff: Optional[torch.Tensor] = None


class UniformEnv(NamedTuple):
    """Constant environment with a flat spectrum (`uniform.cpp` on
    `constant.cpp`): in spectral mode the channels' mean holds at every
    wavelength, with no upsampling and no illuminant."""
    radiance: torch.Tensor       # (C,) equal channels


def _flat(env, d_world, wavelengths):
    """The radiance of a ConstantEnv or UniformEnv toward d_world."""
    if wavelengths is not None:
        if isinstance(env, ConstantEnv):
            coeff = (fit_sigmoid_coeffs_torch(env.radiance)
                     if env.coeff is None else env.coeff)
            return eval_emitter_coeff_spectrum(coeff, wavelengths).expand(
                wavelengths.shape)
        return env.radiance.mean().expand(wavelengths.shape)
    return env.radiance.expand(d_world.shape[:-1] + env.radiance.shape)


def _check(env):
    if not isinstance(env, (sunsky.SunskyState, ConstantEnv, UniformEnv,
                            EnvMapState)):
        raise NotImplementedError(f"environment {type(env).__name__}")


def env_eval(env, d_world, env_to_world, wavelengths=None, mode="rgb",
             plain=False):
    """Environment radiance toward world direction d (pointing at the sky)."""
    _check(env)
    if isinstance(env, sunsky.SunskyState):
        return sunsky.eval(env, mat3_apply_t(env_to_world, d_world),
                           wavelengths, mode, plain=plain)
    if isinstance(env, EnvMapState):
        d_local = mat3_apply_t(env_to_world, d_world)
        if wavelengths is None:
            return envmap_eval(env, d_local)
        if env.coeff is not None:
            return envmap_spectrum(env, d_local, wavelengths)
        return envmap_eval(env, d_local).mean(-1, keepdim=True).expand(
            wavelengths.shape)
    return _flat(env, d_world, wavelengths)


def env_pdf_direction(env, env_to_world, d_world):
    """Solid-angle pdf of `env_sample_direction` toward d_world."""
    _check(env)
    if isinstance(env, sunsky.SunskyState):
        return sunsky.pdf_direction(env, mat3_apply_t(env_to_world, d_world))
    if isinstance(env, EnvMapState):
        return envmap_pdf_direction(env, mat3_apply_t(env_to_world, d_world))
    return torch.full(d_world.shape[:-1], warp.INV_FOUR_PI,
                      device=d_world.device)


def env_sample_direction(env, env_to_world, sample2):
    """Importance-sample a world direction toward the environment ->
    (d_world, pdf): the sunsky's TGMM + sun-cone mixture, the envmap's
    bilinear luminance warp, or the uniform sphere for a constant
    environment."""
    _check(env)
    if isinstance(env, sunsky.SunskyState):
        d_local, pdf = sunsky.sample_direction(env, sample2)
        return mat3_apply(env_to_world, d_local), pdf
    if isinstance(env, EnvMapState):
        d_local, pdf = envmap_sample_direction(env, sample2)
        return mat3_apply(env_to_world, d_local), pdf
    d = warp.square_to_uniform_sphere(sample2)
    return d, torch.full(d.shape[:-1], warp.INV_FOUR_PI, device=d.device)


def env_eval_pdf(env, d_world, env_to_world, wavelengths=None, mode="rgb",
                 pdf_detached=False, plain=False):
    """(radiance, solid-angle pdf) toward d_world: the emitter-hit MIS
    block (kernel K2, or K10 in spectral mode, for CUDA tensors).
    `pdf_detached` declares that the caller uses the pdf detached."""
    _check(env)
    if isinstance(env, sunsky.SunskyState):
        return sunsky.eval_pdf(env, mat3_apply_t(env_to_world, d_world),
                               wavelengths, mode, pdf_detached=pdf_detached,
                               plain=plain)
    pdf = env_pdf_direction(env, env_to_world, d_world)
    return (env_eval(env, d_world, env_to_world, wavelengths, mode),
            pdf.detach() if pdf_detached else pdf)


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
    d = d.detach()
    return (d, env_eval(env, d, env_to_world, wavelengths, mode),
            pdf.detach() if pdf_detached else pdf)


# ---------------------------------------------------------------------------
# Bitmap environment emitter (lat-long) with a bilinear importance warp
# ---------------------------------------------------------------------------


class EnvMapState(NamedTuple):
    """Lat-long environment map (`envmap.cpp`) sampled by a warp whose
    density is bilinear between texel vertices (`ops/distr2d.Bilinear2D`,
    the counterpart of the reference's `Hierarchical2D<0>` over bilinear
    texels, `envmap.cpp:103,:233`), so `envmap_pdf_direction` is
    continuous."""
    bitmap: torch.Tensor     # (H, W, 3)
    warp: Bilinear2D         # over the (H+1, W+1) vertices
    scale: torch.Tensor      # () radiance scale
    coeff: Optional[torch.Tensor] = None  # (H, W, 4) rgb2spec coefficients


def make_envmap(bitmap, scale=1.0, spectral=False,
                device="cuda") -> EnvMapState:
    """An envmap emitter from an (H, W, 3) radiance bitmap, its warp built
    on `device` (`tpusky/render/emitters.py:307-335`). u = phi / 2pi
    (the x axis at u = 0), v = theta / pi (the zenith at v = 0).
    `spectral=True` fits every texel's rgb2spec coefficients on the host
    (float64 numpy, about 10 s a megatexel), so that spectral mode shows
    each texel's spectrum rather than the channels' mean."""
    host = np.asarray(bitmap, np.float32)
    bm = torch.tensor(host, device=device)
    h = bm.shape[0]
    lum = (0.212671 * bm[..., 0] + 0.715160 * bm[..., 1]
           + 0.072169 * bm[..., 2])
    # (H+1, W+1) vertices: the mean of the adjacent texel centres (edge
    # rows clamp, columns wrap) times sin(theta) at the vertex, so the
    # poles weigh nothing
    row_pad = torch.cat([lum[:1], lum, lum[-1:]], 0)
    vy = 0.5 * (row_pad[:-1] + row_pad[1:])             # (H+1, W)
    col_pad = torch.cat([vy[:, -1:], vy], 1)
    vx = 0.5 * (col_pad[:, :-1] + col_pad[:, 1:])       # (H+1, W)
    vtx = torch.cat([vx, vx[:, :1]], 1)                 # u = 1 is u = 0
    theta_v = torch.arange(h + 1, device=device) / h * PI
    vtx = vtx * torch.sin(theta_v)[:, None]
    coeff = None
    if spectral:
        coeff = torch.tensor(emitter_coeffs(host).astype(np.float32),
                             device=device)
    return EnvMapState(bm, make_bilinear_2d(vtx),
                       torch.tensor(scale, dtype=torch.float32,
                                    device=device), coeff)


def _envmap_uv(d):
    u = torch.remainder(torch.atan2(d[..., 1], d[..., 0]) / (2.0 * PI), 1.0)
    return u, safe_acos(d[..., 2]) / PI


def envmap_eval(env: EnvMapState, d):
    """Bilinear radiance lookup toward local direction d -> (..., 3)."""
    h, w = env.bitmap.shape[:2]
    u, v = _envmap_uv(d)
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64).clamp(0, h - 1)
    tx = (x - x0)[..., None]
    ty = (y - torch.floor(y))[..., None]
    x0 = torch.remainder(x0, w)
    x1 = torch.remainder(x0 + 1, w)
    y1 = (y0 + 1).clamp(0, h - 1)
    c00 = env.bitmap[y0, x0]
    c10 = env.bitmap[y0, x1]
    c01 = env.bitmap[y1, x0]
    c11 = env.bitmap[y1, x1]
    top = c00 * (1 - tx) + c10 * tx
    bot = c01 * (1 - tx) + c11 * tx
    return env.scale * (top * (1 - ty) + bot * ty)


def envmap_spectrum(env: EnvMapState, d, wavelengths):
    """The nearest texel's rgb2spec spectrum (times D65 and the scale)
    toward local direction d at the hero wavelengths -> (..., W)."""
    h, w = env.bitmap.shape[:2]
    u, v = _envmap_uv(d)
    col = (u * w).to(torch.int64).clamp(0, w - 1)
    row = (v * h).to(torch.int64).clamp(0, h - 1)
    cf = env.coeff.reshape(-1, 4)[row * w + col]
    return env.scale * eval_emitter_coeff_spectrum(cf, wavelengths)


def envmap_sample_direction(env: EnvMapState, sample2):
    """Luminance-importance sample of a local direction -> (d, pdf)."""
    xy, pdf_uv = bilinear_sample(env.warp, sample2)
    phi = xy[..., 0] * 2.0 * PI
    theta = xy[..., 1] * PI
    st = torch.sin(theta)
    d = torch.stack([torch.cos(phi) * st, torch.sin(phi) * st,
                     torch.cos(theta)], -1)
    return d, pdf_uv / (2.0 * PI * PI * st.clamp(min=1e-6))


def envmap_pdf_direction(env: EnvMapState, d):
    u, v = _envmap_uv(d)
    pdf_uv = bilinear_pdf(env.warp, torch.stack([u, v], -1))
    st = torch.sqrt((1.0 - d[..., 2] ** 2).clamp(min=0.0))
    return pdf_uv / (2.0 * PI * PI * st.clamp(min=1e-6))


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
