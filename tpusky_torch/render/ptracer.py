"""Adjoint particle tracer (light tracing), `tpusky/render/ptracer.py`.

Particles start on the emitters, walk through the scene, and every
vertex splats its contribution through the pinhole camera's importance
(the reference's `ptracer.cpp`). With a pixel's value the mean radiance
over its footprint, the importance of a perspective camera in solid
angle is (H W) / (A cos^3 theta), A = 4 tan^2(fov / 2) / aspect the film
plane's area at unit distance.

Strategies, one picked a particle with equal probability: area emitters
(a point uniform in area, a cosine direction), point lights, spot lights
(a direction uniform in the cone), directional-area emitters (a delta
direction along the normal, `directionalarea.cpp`) and the environment
(a direction from its sampler, launched inward from a disc of the scene's
bounding sphere). Spectral mode is hero-wavelength transport: 4
wavelengths a particle from the RGB-sensor response, or for the sunsky's
particles from its spectral distribution (`model.sample_wavelengths`),
each splat developed to sRGB. Light seen directly by camera rays is not
sampled (the reference's tracer shares this).

The splats are deterministic: each sorts its lanes by pixel (stable) and
sums each pixel's run in a fixed order (`_segment_sum`), with no atomics,
so two calls give bitwise equal images on the card. On the card the
sunsky's radiance is kernel K1 (K9 in spectral mode) and the mesh
queries K14; `plain=True` runs their plain versions. The walk meets the
analytic shapes, the mesh and the SDF grid (`tpusky/render/ptracer.py:
302-335`). The reference reads neither textures nor media here (R15), so
a scene with either raises; nor does its walk meet curves, which its
shadow rays do see (R19), so a scene with curves raises too.
"""

from __future__ import annotations

import math

import torch

from ..models.sunsky import model as sunsky
from ..ops import spectrum, warp
from ..ops.math import Frame, dot, mat3_apply_t
from ..ops.rgb2spec import (eval_emitter_coeff_spectrum,
                           fit_sigmoid_coeffs_torch)
from . import bsdf as bsdf_mod
from . import emitters as em
from .integrator import _SHADOW_EPS, _SamplerCtx, _scene_hit
from .scene import (Scene, scene_occluded, table_len, with_emitter_coeffs,
                    with_mesh_tables)
from .sensors import Perspective
from .shapes import sample_position


def _sensor_connect(sensor: Perspective, p):
    """The connection p -> pinhole camera -> (film uv (..., 2), w_cam,
    direction to the camera, distance, valid): a splat is beta f cos
    w_cam, w_cam = 1 / (A cos^3 theta dist^2), 0 off the film."""
    to_cam = sensor.to_world[:3, 3] - p
    dist2 = (to_cam * to_cam).sum(-1)
    dist = torch.sqrt(dist2.clamp(min=1e-12))
    d = to_cam / dist[..., None]
    d_cam = mat3_apply_t(sensor.to_world[:3, :3], -d)
    z = d_cam[..., 2]
    valid = z > 1e-6
    zs = z.clamp(min=1e-6)
    tan_half = torch.tan(0.5 * torch.deg2rad(sensor.fov_x_deg))
    u = 0.5 * (d_cam[..., 0] / zs / tan_half + 1.0)
    v = 0.5 * (1.0 - d_cam[..., 1] / zs * sensor.aspect / tan_half)
    inside = valid & (u >= 0.0) & (u < 1.0) & (v >= 0.0) & (v < 1.0)
    area = 4.0 * tan_half * tan_half / sensor.aspect
    w_cam = 1.0 / (area * zs * zs * zs * dist2.clamp(min=1e-12))
    return (torch.stack([u, v], -1), torch.where(inside, w_cam, 0.0), d,
            dist, inside)


def _segment_sum(values, seg, n_seg: int):
    """Per-segment sums of values (N, C) -> (n_seg, C), deterministic: the
    lanes sorted by segment (stable), each run summed by a segmented
    doubling scan in a fixed association (log2 N steps), the run's last
    lane written to its segment. No atomics."""
    seg, perm = torch.sort(seg, stable=True)
    v = values[perm]
    n = v.shape[0]
    k = 1
    while k < n:
        same = (seg[k:] == seg[:-k])[..., None]
        v = torch.cat([v[:k], v[k:] + torch.where(same, v[:-k], 0.0)])
        k *= 2
    last = torch.ones_like(seg, dtype=torch.bool)
    last[:-1] = seg[1:] != seg[:-1]
    out = v.new_zeros((n_seg + 1, v.shape[-1]))
    out[torch.where(last, seg, n_seg)] = v      # one writer a segment
    return out[:n_seg]


def _splat(h: int, w: int, accum, uv, value, ok):
    """accum (h * w, 3) plus the lanes' values at their film uv where ok
    (`ptracer.py:81-87`)."""
    px = (uv[..., 0] * w).long().clamp(0, w - 1)
    py = (uv[..., 1] * h).long().clamp(0, h - 1)
    contrib = torch.where(ok[..., None], value, 0.0)
    return accum + _segment_sum(contrib, py * w + px, h * w)


def _strategies(scene: Scene):
    out = []
    if table_len(scene.area_emitter_shapes):
        out.append("area")
    if table_len(scene.point_lights):
        out.append("point")
    if scene.spot_lights:
        out.append("spot")
    if scene.dir_area_lit:
        out.append("dir_area")
    if scene.env is not None:
        out.append("env")
    return tuple(out)


def _ptracer_impl(scene: Scene, sensor, h: int, w: int, key,
                  n_particles: int, max_depth: int, strategies,
                  sampler_kind: str, kinds, mode: str, plain: bool):
    """The light-traced image (h, w, 3) (`ptracer.py:93-368`)."""
    n = n_particles
    dev = scene.shapes.to_world.device
    lane = torch.arange(n, dtype=torch.int64, device=dev)
    smp = _SamplerCtx(sampler_kind, key, lane, torch.zeros_like(lane), 1)
    n_strat = len(strategies)
    strat = (smp.next(50_000, 1)[..., 0] * n_strat).long().clamp(
        0, n_strat - 1)
    env = scene.env

    wavelengths = wl_weight = cf = dir_cf = None
    n_chan = 3
    if mode == "spectral":
        u_wl = smp.next(50_004, 1)[..., 0]
        wavelengths, wl_weight = spectrum.sample_rgb_spectrum(
            spectrum.sample_shifted(u_wl, 4))
        if "env" in strategies and isinstance(env, sunsky.SunskyState):
            # the sunsky's particles draw from its spectral distribution
            # (`sunsky.cpp:463`)
            wl_env, pdf_env = sunsky.sample_wavelengths(env, u_wl)
            env_sel = (strat == strategies.index("env"))[..., None]
            wavelengths = torch.where(env_sel, wl_env, wavelengths)
            wl_weight = torch.where(env_sel, 1.0 / pdf_env.clamp(min=1e-9),
                                    wl_weight)
        n_chan = 4
        scene = with_emitter_coeffs(scene)
        cf = scene.emitter_coeffs
        if "dir_area" in strategies:
            dir_cf = fit_sigmoid_coeffs_torch(scene.dir_area_radiance)

    def to_rgb(spec):
        if mode != "spectral":
            return spec
        return spectrum.spectrum_to_srgb(spec * wl_weight, wavelengths)

    def spectral(coeffs):
        return eval_emitter_coeff_spectrum(coeffs, wavelengths)

    def occluded(o, d, maxt):
        return scene_occluded(scene, o, d, maxt, plain=plain)

    accum = torch.zeros((h * w, 3), device=dev)
    o = torch.zeros((n, 3), device=dev)
    d = torch.zeros((n, 3), device=dev)
    beta = torch.zeros((n, n_chan), device=dev)
    u_e = smp.next(50_001, 2)
    u_d = smp.next(50_002, 2)
    scale = float(n_strat)          # 1 / the strategy's probability
    for si, name in enumerate(strategies):
        sel = strat == si
        if name in ("area", "dir_area"):
            u_pick = smp.next(50_003, 1)[..., 0]
            if name == "area":
                n_pick = table_len(scene.area_emitter_shapes)
                pick = (u_pick * n_pick).long().clamp(0, n_pick - 1)
                shape_idx = scene.area_emitter_shapes[pick]
            else:
                n_pick = len(scene.shapes.kind)
                shape_idx = (u_pick * n_pick).long().clamp(0, n_pick - 1)
            p_e, n_e, inv_area = sample_position(scene.shapes, shape_idx,
                                                 u_e)
            pdf_pos = (inv_area / n_pick).clamp(min=1e-12)
            o_s = p_e + n_e * _SHADOW_EPS
            if name == "area":
                rad = (scene.area_radiance[shape_idx] if cf is None
                       else spectral(cf.area[shape_idx]))
                # a cosine direction about the normal: alpha = L pi / pdf
                d_e = Frame(n_e).to_world(
                    warp.square_to_cosine_hemisphere(u_d))
                a0 = rad * (math.pi / pdf_pos)[..., None]
                # the emitter point seen by the camera directly
                uv_c, w_c, d_c, dist_c, ok_c = _sensor_connect(sensor, p_e)
                cos_c = dot(n_e, d_c).clamp(min=0.0)
                occ = occluded(o_s, d_c, dist_c * (1 - 1e-3))
                accum = _splat(h, w, accum, uv_c, to_rgb(
                    rad * (cos_c * w_c / pdf_pos)[..., None] * scale),
                    sel & ok_c & ~occ & (cos_c > 0))
            else:
                # the delta direction along the normal: alpha = L A
                rad = (scene.dir_area_radiance[shape_idx] if dir_cf is None
                       else spectral(dir_cf[shape_idx]))
                d_e = n_e
                a0 = rad * (1.0 / pdf_pos)[..., None]
        elif name == "point":
            pl = scene.point_lights
            n_pt = pl.shape[0]
            pick = (smp.next(50_003, 1)[..., 0] * n_pt).long().clamp(
                0, n_pt - 1)
            p_e = pl[pick, :3]
            inten = pl[pick, 3:] if cf is None else spectral(cf.point[pick])
            d_e = warp.square_to_uniform_sphere(u_d)
            a0 = inten * (4.0 * math.pi * n_pt)
            uv_c, w_c, d_c, dist_c, ok_c = _sensor_connect(sensor, p_e)
            occ = occluded(p_e, d_c, dist_c * (1 - 1e-3))
            accum = _splat(h, w, accum, uv_c,
                           to_rgb(inten * (w_c * n_pt * scale)[..., None]),
                           sel & ok_c & ~occ)
            o_s = p_e
        elif name == "spot":
            spots = scene.spot_lights
            n_sp = len(spots)
            pick = (smp.next(50_003, 1)[..., 0] * n_sp).long().clamp(
                0, n_sp - 1)
            p_e = torch.zeros((n, 3), device=dev)
            d_e = torch.zeros((n, 3), device=dev)
            fall = torch.zeros((n, 3), device=dev)
            solid = torch.zeros((n,), device=dev)
            for li, light in enumerate(spots):
                m = pick == li
                d_w = Frame(light.direction.expand(n, 3)).to_world(
                    warp.square_to_uniform_cone(u_d, light.cos_cutoff))
                p_e = torch.where(m[..., None], light.position, p_e)
                d_e = torch.where(m[..., None], d_w, d_e)
                fall = torch.where(m[..., None], em.spot_falloff(light, d_w),
                                   fall)
                solid = torch.where(m, 2.0 * math.pi
                                    * (1.0 - light.cos_cutoff), solid)

            def spot_spec(fall_rgb):
                """The falloff (RGB) -> the spot's spectrum times the
                falloff's ratio to its intensity (the path tracer's
                convention)."""
                if cf is None:
                    return fall_rgb
                out = torch.zeros((n, n_chan), device=dev)
                for li, light in enumerate(spots):
                    ratio = (fall_rgb.sum(-1)
                             / light.intensity.sum().clamp(min=1e-12))
                    out = torch.where((pick == li)[..., None],
                                      spectral(cf.spot[li])
                                      * ratio[..., None], out)
                return out
            a0 = spot_spec(fall) * (solid * n_sp)[..., None]
            uv_c, w_c, d_c, dist_c, ok_c = _sensor_connect(sensor, p_e)
            fall_c = torch.zeros((n, 3), device=dev)
            for li, light in enumerate(spots):
                fall_c = torch.where((pick == li)[..., None],
                                     em.spot_falloff(light, d_c), fall_c)
            occ = occluded(p_e, d_c, dist_c * (1 - 1e-3))
            accum = _splat(h, w, accum, uv_c, to_rgb(
                spot_spec(fall_c) * (w_c * n_sp * scale)[..., None]),
                sel & ok_c & ~occ)
            o_s = p_e
        else:
            # the environment, inward from a disc of the bounding sphere
            d_sky, pdf_dir = em.env_sample_direction(env, scene.env_to_world,
                                                     u_e)
            rad = em.env_eval(env, d_sky, scene.env_to_world, wavelengths,
                              mode, plain=plain)
            r = scene.bsphere_radius
            disk = warp.square_to_uniform_disk_concentric(u_d) * r
            o_s = (scene.bsphere_center + r * d_sky
                   + Frame(d_sky).to_world(torch.cat(
                       [disk, torch.zeros_like(disk[..., :1])], -1)))
            d_e = -d_sky
            pdf_pos = 1.0 / (math.pi * r * r)
            a0 = rad / (pdf_dir * pdf_pos).clamp(min=1e-20)[..., None]
        o = torch.where(sel[..., None], o_s, o)
        d = torch.where(sel[..., None], d_e, d)
        beta = torch.where(sel[..., None], a0 * scale, beta)

    active = (beta > 0).any(-1)
    for depth in range(max_depth - 1):
        _, p, ng, _, mat_idx, hit = _scene_hit(scene, o, d, plain)
        active = active & hit
        frame = Frame(ng)
        wi_local = frame.to_local(-d)
        # this vertex seen by the camera
        uv_c, w_c, d_c, dist_c, ok_c = _sensor_connect(sensor, p)
        f_c, _ = bsdf_mod.eval_pdf(scene.bsdfs, mat_idx, wi_local,
                                   frame.to_local(d_c), wavelengths,
                                   kinds=kinds)
        off = p + torch.sign(dot(ng, d_c))[..., None] * ng * _SHADOW_EPS
        occ = occluded(off, d_c, dist_c * (1 - 1e-3))
        accum = _splat(h, w, accum, uv_c, to_rgb(beta * f_c * w_c[..., None]),
                       active & ok_c & ~occ)
        # the walk goes on
        u_b = smp.next(60_000 + 3 * depth, 3)
        wo, weight, pdf_b, _ = bsdf_mod.sample(
            scene.bsdfs, mat_idx, wi_local, u_b[..., :2], u_b[..., 2],
            wavelengths, kinds=kinds)
        d_next = frame.to_world(wo)
        beta = beta * weight
        active = active & (pdf_b > 0.0) & (beta > 0).any(-1)
        off_n = p + torch.sign(dot(ng, d_next))[..., None] * ng * _SHADOW_EPS
        o = torch.where(active[..., None], off_n, o)
        d = torch.where(active[..., None], d_next, d)
    return accum.reshape(h, w, 3) * (float(h * w) / float(n_particles))


def render_ptracer(scene: Scene, sensor, film_cfg, key,
                   n_particles: int = 1 << 20, max_depth: int = 4,
                   sampler_kind: str = "independent", mode: str = "rgb",
                   plain: bool = False):
    """Light-traced image (H, W, 3) through a perspective sensor, in RGB
    or spectral mode (`ptracer.py:371-399`). `key` as in
    `integrator.render` (an integer seed or the reference key's two
    uint32 words; the reference keys the particles on the key itself, not
    a pass's). `plain=True` runs the plain sunsky and mesh functions on
    any device. A scene with textures or a medium raises (R15), and so
    does one with curves (R19)."""
    if not isinstance(sensor, Perspective):
        raise TypeError("ptracer supports the perspective sensor")
    if scene.textures is not None or scene.medium is not None:
        # R15: the reference's tracer reads neither (`ptracer.py:300-360`)
        raise NotImplementedError(
            "R15: the particle tracer of a scene with textures, normal maps "
            "or a medium (the reference reads none of them)")
    if scene.curve is not None:
        # R19: the reference's walk does not intersect curves
        # (`ptracer.py:302-335`) while its shadow rays do (`:75-78`), so a
        # light-traced curve casts shadows but is never lit or seen
        raise NotImplementedError(
            "R19: the particle tracer of a scene with curves (the "
            "reference's walk never meets them, its shadow rays do)")
    if mode not in ("rgb", "spectral"):
        raise NotImplementedError(f"render mode {mode!r}")
    kinds = bsdf_mod.table_kinds(scene.bsdfs)
    bsdf_mod.check_kinds(kinds[0])
    h, w = film_cfg.height, film_cfg.width
    strategies = _strategies(scene)
    if not strategies:
        return torch.zeros((h, w, 3), device=scene.shapes.to_world.device)
    return _ptracer_impl(with_mesh_tables(scene, plain), sensor, h, w, key,
                         n_particles, max_depth, strategies, sampler_kind,
                         kinds, mode, plain)
