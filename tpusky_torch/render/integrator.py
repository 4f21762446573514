"""Integrator: the wavefront path tracer and the megakernel gate.

The PyTorch counterpart of `tpusky/render/integrator.py`: analytic
shapes (sphere, rectangle, disk, cube, cylinder), triangle meshes
(kernel K14 on the card), every non-polarized material kind but hair
and the measured ones (diffuse, rough conductor, conductor, dielectric,
plastic, rough dielectric, null, thin dielectric, rough plastic,
principled, blend, principledthin) with opacity masks, the sunsky,
constant, uniform and bitmap (envmap) environments or none, area
emitters, point, directional and spot lights, NEE + MIS (power
heuristic, beta = 2, reference `path.cpp:321`) and Russian roulette.
The environments and the lobes enter the path only through
`emitters.env_*` and `bsdf.eval_pdf` / `bsdf.sample`, as in the
reference. Up to two delta lights are each connected at every
vertex; more are sampled one a vertex by their weights
(`scene.cpp:100-119`). Spectral mode is hero-wavelength transport: 4
wavelengths per path from `sample_rgb_spectrum`, developed to sRGB per
lane (the specfilm branches are not ported); a `ConstantEnv`, an
envmap's per-texel spectra, area and delta lights need the reference's
rgb2spec upsampling there, which is not ported. Anything else raises
NotImplementedError.

The whole wavefront (H * W * spp lanes) is one set of tensors and the
bounce loop is a Python loop with per-lane active masks. Uniforms come
from the counter-hash sampler keyed on the global lane index, so an image
does not depend on spp chunking. `render(passes=n)` folds the pass index
into the reference's threefry key on the host (`sampler.fold_in`).

`_render_impl` runs an eligible scene on the card through the fused
megakernel K4 (`ops/cuda/megakernel.py`), and every other scene through
the wavefront path, whose sunsky lookups are kernels K2 and K3 (K10 and
K11 in spectral mode) and whose mesh queries are kernel K14 for CUDA
tensors; the other emitters and the shapes are plain tensor code on any
device. `plain=True` runs the wavefront path with the plain sunsky and
mesh functions on any device: the reference the kernels are held
against.

Gradients: the wavefront path is plain tensor code, so torch autograd
differentiates it; on the card its sky lookups, whose pdfs the estimator
uses detached, transpose into the adjoint kernels K5 and K6 (RGB) or K12
and K13 without the pdf (spectral). K4 has no adjoint: `_Megakernel` runs it forward and
replays the wavefront path under autograd in its backward, as the
reference package's `mega` custom_jvp does
(`tpusky/render/integrator.py:989-1026`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..models.sunsky.model import SunskyState
from ..ops import spectrum
from ..ops.distr import discrete_sample_reuse, make_discrete
from ..ops.math import Frame, dot, norm
from . import bsdf as bsdf_mod
from . import emitters as em
from . import film as film_mod
from . import sensors as sensors_mod
from .mesh import mesh_intersect
from .sampler import fold_in, lane_samples
from .scene import (Scene, n_delta_lights, scene_occluded, table_len,
                    with_mesh_tables)
from .shapes import DISK, RECTANGLE, SPHERE, ray_intersect

_SHADOW_EPS = 1e-3
_DIFFUSE_ONLY = ((bsdf_mod.DIFFUSE,), False)
_K4_SHAPES = (SPHERE, RECTANGLE, DISK)
_N_HERO = 4             # hero wavelengths per path


def _mis_weight(pdf_a, pdf_b):
    """Power heuristic with beta=2 (`path.cpp:321-327`)."""
    a2 = pdf_a * pdf_a
    b2 = pdf_b * pdf_b
    w = a2 / (a2 + b2)
    return torch.where(torch.isfinite(w), w, 0.0)


class _SamplerCtx:
    """Per-render sampler context bound to lane identities."""

    def __init__(self, kind, seed, pixel_idx, sample_idx, spp):
        self.kind = kind
        self.seed = seed
        self.pixel_idx = pixel_idx
        self.sample_idx = sample_idx
        self.spp = spp

    def next(self, dim, n):
        return lane_samples(self.kind, self.seed, self.pixel_idx,
                            self.sample_idx, self.spp, dim, n)


def _check_slice(scene: Scene, max_depth, rr_depth, mode, kinds):
    if mode not in ("rgb", "spectral"):
        raise NotImplementedError(f"render mode {mode!r}")
    env = scene.env
    if not (env is None or isinstance(env, (SunskyState, em.ConstantEnv,
                                            em.UniformEnv, em.EnvMapState))):
        raise NotImplementedError(f"environment {type(env).__name__}")
    if (isinstance(env, SunskyState)
            and (mode == "spectral") != (env.sun_ld is not None)):
        raise ValueError(f"a {mode} render needs a sunsky state "
                         f"precomputed in {mode} mode")
    if mode == "spectral":
        for what, present in (
                ("a ConstantEnv", isinstance(env, em.ConstantEnv)),
                ("area emitters", scene.area_radiance is not None),
                ("delta lights", n_delta_lights(scene) > 0)):
            if present:
                raise NotImplementedError(
                    f"{what} in spectral mode need ops/rgb2spec.py (the "
                    "reference's emitter upsampling), which is not ported")
    if max_depth < 1:
        raise NotImplementedError(f"max_depth {max_depth}")
    if kinds is not None:
        bsdf_mod.check_kinds(kinds[0])


def _scene_hit(scene: Scene, o, d, plain: bool):
    """Closest hit over the analytic shapes and the mesh -> (t, p, ng,
    shape index (-2 on a mesh hit), material index, hit). A mesh hit
    closer than the shapes' takes the hit point o + t d, the interpolated
    shading normal as ng and the triangle's material
    (`tpusky/render/integrator.py:274-289, 410-411`)."""
    t, p, ng, shape_idx, hit = ray_intersect(scene.shapes, o, d)
    mat_idx = scene.shapes.bsdf_idx[shape_idx.clamp(min=0)]
    if scene.mesh is not None:
        tm, nm, matm, _, _, _, hitm = mesh_intersect(
            scene.mesh, o, d, plain=plain, tables=scene.mesh_tables)
        use_mesh = hitm & (tm < t)
        t = torch.where(use_mesh, tm, t)
        p = torch.where(use_mesh[..., None], o + tm[..., None] * d, p)
        ng = torch.where(use_mesh[..., None], nm, ng)
        shape_idx = torch.where(use_mesh, -2, shape_idx)
        mat_idx = torch.where(use_mesh, matm, mat_idx)
        hit = hit | hitm
    return t, p, ng, shape_idx, mat_idx, hit


def _scene_intersect(scene: Scene, o, d, plain: bool):
    """`_scene_hit` without the shape index -> (t, p, ng, material index,
    hit)."""
    t, p, ng, _, mat_idx, hit = _scene_hit(scene, o, d, plain)
    return t, p, ng, mat_idx, hit


def _offset(p, ng, dirs):
    """A shadow or continuation ray's origin: p moved off the surface
    along +-ng, toward dirs."""
    return p + torch.sign(dot(ng, dirs))[..., None] * ng * (
        _SHADOW_EPS * norm(p, keepdim=True).clamp(min=1.0))


def _light_rows(x, device):
    """An optional (N, 6) light table, empty for None."""
    return torch.zeros((0, 6), device=device) if x is None else x


def _delta_lights_unrolled(scene, p, ng, frame, wi_local, mat_idx,
                           throughput, active, kinds, plain):
    """Each delta light connected at every vertex (at most 2 lights;
    `tpusky/render/integrator.py:523-600`)."""
    acc = torch.zeros_like(throughput)

    def connect(d_l, maxt):
        """(f cos toward d_l, lanes the light reaches)."""
        f_l, _ = bsdf_mod.eval_pdf(scene.bsdfs, mat_idx, wi_local,
                                   frame.to_local(d_l), kinds=kinds)
        occ = scene_occluded(scene, _offset(p, ng, d_l), d_l, maxt,
                             plain=plain)
        return f_l, (active & ~occ)[..., None]

    def toward(position):
        to_l = position - p
        dist2 = (to_l * to_l).sum(-1)
        dist = torch.sqrt(dist2.clamp(min=1e-12))
        return to_l / dist[..., None], dist, dist2[..., None]

    pl = _light_rows(scene.point_lights, p.device)
    for li in range(pl.shape[0]):
        d_l, dist, dist2 = toward(pl[li, :3])
        f_l, ok = connect(d_l, dist * (1 - 1e-3))
        acc = acc + torch.where(ok, throughput * f_l * pl[li, 3:] / dist2,
                                0.0)
    dl = _light_rows(scene.directional_lights, p.device)
    for li in range(dl.shape[0]):
        d_l = -dl[li, :3]
        d_l = (d_l / norm(d_l)).expand(p.shape)
        f_l, ok = connect(d_l, torch.inf)
        acc = acc + torch.where(ok, throughput * f_l * dl[li, 3:], 0.0)
    for light in scene.spot_lights:
        d_l, dist, dist2 = toward(light.position)
        f_l, ok = connect(d_l, dist * (1 - 1e-3))
        acc = acc + torch.where(
            ok, throughput * f_l * em.spot_falloff(light, -d_l) / dist2, 0.0)
    return acc


def _delta_lights_single_sample(scene, u_pick, p, ng, frame, wi_local,
                                mat_idx, throughput, active, kinds, plain):
    """One delta light a vertex, picked by its sampling weight (the
    reference's DiscreteDistribution over `sampling_weight()`,
    `scene.cpp:100-119, 295-345`; `tpusky/render/integrator.py:109-215`):
    the connection over the pick's probability."""
    dev = p.device
    pl = _light_rows(scene.point_lights, dev)
    dl = _light_rows(scene.directional_lights, dev)
    n_pt, n_dir = pl.shape[0], dl.shape[0]
    spots = scene.spot_lights
    n_delta = n_pt + n_dir + len(spots)
    w = scene.delta_light_weights
    if w is None:
        w = torch.ones((n_delta,), device=dev)
    w = w.detach().clamp(min=0.0)
    pmf = w / w.sum().clamp(min=1e-12)
    idx, _ = discrete_sample_reuse(make_discrete(w), u_pick)

    def stack(rows):
        return torch.cat([r.reshape(-1, 3) for r in rows], 0)
    zeros = torch.zeros((n_delta, 3), device=dev)
    pos_rows = stack([pl[:, :3], zeros[:n_dir]]
                     + [light.position for light in spots])
    dir_rows = stack([zeros[:n_pt], dl[:, :3], zeros[:len(spots)]])
    inten_rows = stack([pl[:, 3:], dl[:, 3:]]
                       + [light.intensity for light in spots])
    lp, ld, intensity = pos_rows[idx], dir_rows[idx], inten_rows[idx]
    pmf_sel = pmf[idx]
    is_dir = (idx >= n_pt) & (idx < n_pt + n_dir)
    is_spot = idx >= n_pt + n_dir

    to_l = lp - p
    dist2 = (to_l * to_l).sum(-1)
    dist = torch.sqrt(dist2.clamp(min=1e-12))
    d_pos = to_l / dist[..., None]
    d_dirn = -ld / norm(ld, keepdim=True).clamp(min=1e-12)
    d_l = torch.where(is_dir[..., None], d_dirn, d_pos)
    maxt = torch.where(is_dir, torch.inf, dist * (1.0 - 1e-3))
    f_l, _ = bsdf_mod.eval_pdf(scene.bsdfs, mat_idx, wi_local,
                               frame.to_local(d_l), kinds=kinds)
    occ = scene_occluded(scene, _offset(p, ng, d_l), d_l, maxt, plain=plain)
    fall = intensity
    for si, light in enumerate(spots):
        fall = torch.where((idx == n_pt + n_dir + si)[..., None],
                           em.spot_falloff(light, -d_l), fall)
    intensity = torch.where(is_spot[..., None], fall, intensity)
    geo = torch.where(is_dir, 1.0, 1.0 / dist2.clamp(min=1e-12))
    contrib = (throughput * f_l * intensity
               * (geo / pmf_sel.clamp(min=1e-12))[..., None])
    ok = active & ~occ & (pmf_sel > 0.0)
    return torch.where(ok[..., None], contrib, 0.0)


def _path_sample(scene: Scene, o, d, smp: _SamplerCtx, max_depth: int,
                 rr_depth: int, mode: str, kinds=None, plain=False,
                 wavelengths=None, rr_log=None):
    """Estimate radiance along primary rays o, d -> (N, C): C = 3 in RGB
    mode, W at the lanes' hero wavelengths (N, W) in spectral mode.

    max_depth counts path vertices like the reference (2 == direct
    illumination); Russian roulette starts where depth + 1 >= rr_depth.
    Sample placement and every pdf in a MIS weight or an estimator's
    denominator are detached exactly where the reference package's
    `_path_sample` detaches them (`prb.py:147-160`); each `.detach()`
    below names its line in `tpusky/render/integrator.py`. A list
    `rr_log` receives, at each depth that plays Russian roulette, the
    lanes it ends."""
    _check_slice(scene, max_depth, rr_depth, mode, kinds)
    n = o.shape[0]
    dev = o.device
    env, env_to_world = scene.env, scene.env_to_world
    n_area = table_len(scene.area_emitter_shapes)
    n_delta = n_delta_lights(scene)
    n_chan = 3 if wavelengths is None else wavelengths.shape[-1]
    throughput = torch.ones((n, n_chan), device=dev)
    result = torch.zeros((n, n_chan), device=dev)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    prev_bsdf_pdf = torch.ones((n,), device=dev)
    prev_bsdf_delta = torch.ones((n,), dtype=torch.bool, device=dev)

    def emitter_hits(result, active, o, d, throughput, prev_bsdf_pdf,
                     prev_bsdf_delta):
        """(hit geometry, result plus the escaped lanes' environment
        radiance and the area emitters' radiance at hits, each weighted
        by MIS against the previous BSDF sample)."""
        geo = _scene_hit(scene, o, d, plain)
        _, p, ng, shape_idx, _, hit = geo
        if env is not None:
            env_l, em_pdf = em.env_eval_pdf(env, d, env_to_world,
                                            wavelengths, mode,
                                            pdf_detached=True, plain=plain)
            em_pdf = torch.where(prev_bsdf_delta, 0.0, em_pdf)
            # sg(em_pdf): tpusky/render/integrator.py:371 (loop), :765
            mis_em = _mis_weight(prev_bsdf_pdf, em_pdf.detach())
            escaped = active & ~hit
            result = result + torch.where(
                escaped[..., None], throughput * env_l * mis_em[..., None],
                0.0)
        if scene.area_radiance is not None:
            contrib = throughput * scene.area_radiance[shape_idx.clamp(min=0)]
            if n_area > 0:
                area_pdf = em.area_pdf_direction(scene, o, p, ng,
                                                 shape_idx.clamp(min=0))
                area_pdf = torch.where(prev_bsdf_delta, 0.0, area_pdf)
                # sg(area_hit_pdf): :393 (loop), :784 (last)
                contrib = contrib * _mis_weight(prev_bsdf_pdf,
                                                area_pdf.detach())[..., None]
            facing = (dot(ng, -d) > 0.0) & (shape_idx >= 0)
            result = result + torch.where(
                (active & hit & facing)[..., None], contrib, 0.0)
        return geo, result

    for depth in range(max_depth - 1):
        (_, p, ng, _, mat_idx, hit), result = emitter_hits(
            result, active, o, d, throughput, prev_bsdf_pdf,
            prev_bsdf_delta)
        active = active & hit
        frame = Frame(ng)
        wi_local = frame.to_local(-d)

        # ---- next-event estimation toward the environment ----
        if env is not None:
            u_nee = smp.next(3 * depth + 0, 2).detach()      # :464
            d_e, l_e, pdf_e = em.env_sample_eval(
                env, env_to_world, u_nee, wavelengths, mode,
                pdf_detached=True, plain=plain)
            pdf_e = pdf_e.detach()                            # :470
            f_val, pdf_b = bsdf_mod.eval_pdf(
                scene.bsdfs, mat_idx, wi_local, frame.to_local(d_e),
                wavelengths, kinds=kinds)
            occluded = scene_occluded(scene, _offset(p, ng, d_e), d_e,
                                      torch.inf, plain=plain)
            mis_nee = _mis_weight(pdf_e, pdf_b.detach())      # :480
            contrib = (throughput * f_val * l_e
                       * (mis_nee / pdf_e.clamp(min=1e-20))[..., None])
            ok = active & ~occluded & (pdf_e > 0.0)
            result = result + torch.where(ok[..., None], contrib, 0.0)

        # ---- next-event estimation toward the area emitters ----
        if n_area > 0:
            u_area = smp.next(3 * depth + 3, 3).detach()     # :490
            d_a, dist_a, pdf_a, l_a, _, _ = em.area_sample_direction(
                scene, p, u_area[..., :2], u_area[..., 2])
            d_a, pdf_a = d_a.detach(), pdf_a.detach()         # :494-495
            f_a, pdf_b_a = bsdf_mod.eval_pdf(
                scene.bsdfs, mat_idx, wi_local, frame.to_local(d_a),
                wavelengths, kinds=kinds)
            # the shadow ray starts along itself (the reference's
            # spawn_ray_to): an offset along the normal would shorten the
            # distance to the emitter point unboundedly at grazing angles
            eps_a = _SHADOW_EPS * norm(p).clamp(min=1.0)
            occ_a = scene_occluded(scene, p + eps_a[..., None] * d_a, d_a,
                                   (dist_a - eps_a) * (1.0 - 1e-3),
                                   plain=plain)
            mis_a = _mis_weight(pdf_a, pdf_b_a.detach())      # :517
            contrib_a = (throughput * f_a * l_a
                         * (mis_a / pdf_a.clamp(min=1e-20))[..., None])
            ok_a = active & ~occ_a & (pdf_a > 0.0)
            result = result + torch.where(ok_a[..., None], contrib_a, 0.0)

        # ---- delta emitters (point / directional / spot) ----
        if n_delta > 2:
            u_pick = smp.next(300_000 + depth, 1)[..., 0].detach()  # :610
            result = result + _delta_lights_single_sample(
                scene, u_pick, p, ng, frame, wi_local, mat_idx, throughput,
                active, kinds, plain)
        elif n_delta > 0:
            result = result + _delta_lights_unrolled(
                scene, p, ng, frame, wi_local, mat_idx, throughput, active,
                kinds, plain)

        # ---- BSDF sampling for the next bounce ----
        u_bsdf = smp.next(3 * depth + 1, 3).detach()         # :618
        wo_local, weight, pdf_b, is_delta = bsdf_mod.sample(
            scene.bsdfs, mat_idx, wi_local, u_bsdf[..., :2], u_bsdf[..., 2],
            wavelengths, kinds=kinds)
        d_next = frame.to_world(wo_local.detach())            # :622
        thr_next = throughput * weight
        active = active & (pdf_b > 0.0)
        if depth + 1 >= rr_depth:
            # Russian roulette, detached (`path.cpp:285-301`; :672-679)
            rr_prob = thr_next.detach().amax(-1).clamp(0.0, 0.95)
            u_rr = smp.next(3 * depth + 2, 1)[..., 0].detach()
            thr_next = thr_next / rr_prob.clamp(min=1e-6)[..., None]
            survive = u_rr < rr_prob
            if rr_log is not None:
                rr_log.append(active & ~survive)
            active = active & survive
        keep = active[..., None]
        o = torch.where(keep, _offset(p, ng, d_next), o)
        d = torch.where(keep, d_next, d)
        throughput = torch.where(keep, thr_next, throughput)
        prev_bsdf_pdf = torch.where(active, pdf_b.detach(),  # :668
                                    prev_bsdf_pdf)
        prev_bsdf_delta = torch.where(active, is_delta, prev_bsdf_delta)

    # final vertex: only the emitter-hit contributions remain
    _, result = emitter_hits(result, active, o, d, throughput,
                             prev_bsdf_pdf, prev_bsdf_delta)
    return result


def _lane_radiance(scene, sensor, film_cfg, seed, spp, spp0, spp_chunk,
                   max_depth, rr_depth, mode, row0, n_rows,
                   sampler_kind="independent", kinds=None, plain=False,
                   rr_log=None):
    """Per-lane radiance (n_rows * W * spp_chunk, 3) of `spp_chunk` of the
    `spp` samples for a block of film rows, lanes pixel-ordered; in
    spectral mode the lanes' spectral radiance developed to linear sRGB.
    Non-finite values are zeroed. `rr_log` as in `_path_sample`."""
    h, w = film_cfg.height, film_cfg.width
    cx0, cy0, cw, _ch = film_mod.crop_extent(film_cfg)
    dev = scene.shapes.to_world.device
    n = n_rows * cw * spp_chunk
    local_lane = torch.arange(n, dtype=torch.int64, device=dev)
    local_pixel = local_lane // spp_chunk
    # full-film pixel ids keep the RNG crop-invariant (`hdrfilm.cpp:137`)
    px_full = cx0 + local_pixel % cw
    py_full = cy0 + row0 + local_pixel // cw
    pixel = py_full * w + px_full
    sample_idx = spp0 + local_lane % spp_chunk

    smp = _SamplerCtx(sampler_kind, seed, pixel, sample_idx, spp)
    u_pos = smp.next(10_000, 2)
    uv = torch.stack([(px_full.float() + u_pos[:, 0]) / w,
                      (py_full.float() + u_pos[:, 1]) / h], -1)
    o, d = sensors_mod.sample_ray(sensor, uv)
    if mode == "spectral":
        # hero-wavelength transport (tpusky/render/integrator.py:862-876)
        u_wl = smp.next(20_000, 1)[..., 0]
        wavelengths, wl_weight = spectrum.sample_rgb_spectrum(
            spectrum.sample_shifted(u_wl, _N_HERO))
        spec = _path_sample(scene, o, d, smp, max_depth, rr_depth, mode,
                            kinds=kinds, plain=plain,
                            wavelengths=wavelengths, rr_log=rr_log)
        radiance = spectrum.spectrum_to_srgb(spec * wl_weight, wavelengths)
    else:
        radiance = _path_sample(scene, o, d, smp, max_depth, rr_depth, mode,
                                kinds=kinds, plain=plain, rr_log=rr_log)
    return torch.where(torch.isfinite(radiance), radiance, 0.0)


def _render_rows_chunk(scene, sensor, film_cfg, seed, spp, spp0, spp_chunk,
                       max_depth, rr_depth, mode, row0, n_rows,
                       sampler_kind="independent", kinds=None, plain=False):
    """Render `spp_chunk` of `spp` samples for a block of film rows ->
    accumulation block (n_rows, W, 4)."""
    if film_cfg.rfilter != "box" or film_cfg.n_channels != 3:
        raise NotImplementedError(f"film {film_cfg.rfilter!r} with "
                                  f"{film_cfg.n_channels} channels")
    radiance = _lane_radiance(scene, sensor, film_cfg, seed, spp, spp0,
                              spp_chunk, max_depth, rr_depth, mode, row0,
                              n_rows, sampler_kind, kinds, plain)
    block = film_mod.Film(n_rows, film_mod.crop_extent(film_cfg)[2],
                          film_cfg.n_channels)
    return film_mod.splat_ordered(block, radiance, spp_chunk)


def _spp_chunk(film_cfg, spp, n_rows, max_lanes):
    """The largest divisor of spp whose chunk of n_rows rows fits the lane
    budget."""
    w = film_mod.crop_extent(film_cfg)[2]
    chunk_cap = max(1, min(spp, max_lanes // max(n_rows * w, 1)))
    return next(c for c in range(chunk_cap, 0, -1) if spp % c == 0)


def render_rows(scene, sensor, film_cfg, seed, spp, max_depth, rr_depth,
                mode, row0, n_rows, max_lanes=(1 << 20),
                sampler_kind="independent", kinds=None, plain=False):
    """Render a block of film rows -> (n_rows, W, 4), bounding the live
    wavefront to `max_lanes` lanes by looping over spp chunks (the
    reference bounds it the same way, `integrator.cpp:247-265`). On the
    card K14's mesh tables are built once for all its queries."""
    scene = with_mesh_tables(scene, plain)
    spp_chunk = _spp_chunk(film_cfg, spp, n_rows, max_lanes)
    accum = None
    for spp0 in range(0, spp, spp_chunk):
        a = _render_rows_chunk(scene, sensor, film_cfg, seed, spp, spp0,
                               spp_chunk, max_depth, rr_depth, mode, row0,
                               n_rows, sampler_kind, kinds, plain)
        accum = a if accum is None else accum + a
    return accum


def _megakernel_ok(scene, sensor, film_cfg, spp, max_depth, mode,
                   sampler_kind, kinds, rr_depth=1000) -> bool:
    """Eligibility for the fused direct-illumination megakernel K4: the
    scene lies on a CUDA device and meets the static rules."""
    return (scene.shapes.to_world.device.type == "cuda"
            and _megakernel_rules(scene, sensor, film_cfg, spp, max_depth,
                                  mode, sampler_kind, kinds, rr_depth))


def _megakernel_rules(scene, sensor, film_cfg, spp, max_depth, mode,
                      sampler_kind, kinds, rr_depth) -> bool:
    """The reference package's static eligibility rules
    (`tpusky/render/integrator.py:955-968`; its backend test is the device
    test in `_megakernel_ok`). K4 draws spheres, rectangles and disks lit
    by the sunsky alone; it also refuses a scene whose shapes emit
    without an area emitter, which the reference lets through."""
    if not (mode == "rgb" and max_depth == 2
            and sampler_kind == "independent"
            and film_cfg.rfilter == "box" and film_cfg.n_channels == 3
            and film_cfg.crop_size is None):
        return False
    # the megakernel has no Russian-roulette logic
    if rr_depth <= max_depth - 1:
        return False
    if not isinstance(scene.env, SunskyState):
        return False
    if scene.mesh is not None or scene.spot_lights:
        return False
    if kinds != _DIFFUSE_ONLY:
        return False
    if any(k not in _K4_SHAPES for k in scene.shapes.kind):
        return False
    if not isinstance(sensor, sensors_mod.Perspective):
        return False
    if (table_len(scene.point_lights) or table_len(scene.directional_lights)
            or table_len(scene.area_emitter_shapes)
            or scene.area_radiance is not None):
        return False
    w, h = film_cfg.width, film_cfg.height
    if spp & (spp - 1) or w * h >= (1 << 24):
        return False
    return True


class _Node(NamedTuple):
    """A NamedTuple of `_flatten`'s structure: its type and children."""
    kind: type
    children: tuple


_LEAF = object()


def _flatten(obj, leaves: list):
    """Structure of nested NamedTuples with their tensors moved to
    `leaves` (everything else stays in the structure)."""
    if isinstance(obj, torch.Tensor):
        leaves.append(obj)
        return _LEAF
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return _Node(type(obj), tuple(_flatten(v, leaves) for v in obj))
    return obj


def _unflatten(structs, leaves):
    """The objects of the structures `structs`, leaves filled in order."""
    it = iter(leaves)

    def build(node):
        if node is _LEAF:
            return next(it)
        if isinstance(node, _Node):
            return node.kind(*(build(c) for c in node.children))
        return node
    return tuple(build(st) for st in structs)


class _Megakernel(torch.autograd.Function):
    """Film accumulation of an eligible scene: K4 forward; the backward
    replays `render_rows` (K2/K3 forward, K5/K6 backward) under autograd
    with the incoming cotangent, so AD never touches K4. The scene's and
    the sensor's tensors come in flattened, since `apply` sees only the
    tensors passed to it."""

    @staticmethod
    def forward(ctx, cfg, struct, *leaves):
        from ..ops.cuda.megakernel import direct_rgb_megakernel
        ctx.cfg, ctx.struct = cfg, struct
        ctx.save_for_backward(*leaves)
        scene, sensor = _unflatten(struct, [t.detach() for t in leaves])
        film_cfg, seed, spp = cfg[:3]
        return direct_rgb_megakernel(scene, sensor, scene.env, seed, spp,
                                     film_cfg.width, film_cfg.height)

    @staticmethod
    def backward(ctx, g_accum):
        film_cfg, seed, spp, max_depth, rr_depth, mode, sampler_kind, \
            kinds = ctx.cfg
        want = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(w)
                      for t, w in zip(ctx.saved_tensors, want)]
            scene, sensor = _unflatten(ctx.struct, leaves)
            accum = render_rows(scene, sensor, film_cfg, seed, spp,
                                max_depth, rr_depth, mode, 0,
                                film_mod.crop_extent(film_cfg)[3],
                                sampler_kind=sampler_kind, kinds=kinds)
            wanted = [t for t, w in zip(leaves, want) if w]
            grads = iter(torch.autograd.grad(accum, wanted, g_accum,
                                             allow_unused=True))
        return (None, None, *(next(grads) if w else None for w in want))


def _render_impl(scene, sensor, film_cfg, seed, spp, max_depth, rr_depth,
                 mode, sampler_kind="independent", kinds=None):
    """Film accumulation (H, W, 4): K4 for an eligible scene on the card,
    the wavefront path otherwise."""
    if _megakernel_ok(scene, sensor, film_cfg, spp, max_depth, mode,
                      sampler_kind, kinds, rr_depth):
        leaves = []
        struct = (_flatten(scene, leaves), _flatten(sensor, leaves))
        cfg = (film_cfg, seed, spp, max_depth, rr_depth, mode, sampler_kind,
               kinds)
        return _Megakernel.apply(cfg, struct, *leaves)
    return render_rows(scene, sensor, film_cfg, seed, spp, max_depth,
                       rr_depth, mode, 0, film_mod.crop_extent(film_cfg)[3],
                       sampler_kind=sampler_kind, kinds=kinds)


def _pass_seeds(key, passes: int):
    """The sampler's seed for each pass. `key` is an integer seed, the
    seed of one pass, or the two uint32 words of the reference package's
    threefry key (`np.asarray(jax.random.key_data(key))`), whose pass p
    the reference keys on `key_data(fold_in(key, p))[-1]`
    (`tpusky/render/integrator.py:1103-1108`, `render/sampler.py:133`)."""
    if isinstance(key, (int, np.integer)):
        if passes != 1:
            raise ValueError("render(passes > 1) takes the key's two uint32 "
                             "words, not an integer seed")
        return [int(key)]
    words = np.asarray(key, np.uint32).reshape(2)
    return [int(fold_in(words, p)[-1]) for p in range(passes)]


def render(scene: Scene, sensor, film: film_mod.Film, key, spp: int = 16,
           max_depth: int = 2, rr_depth: int = 1000, mode: str = "rgb",
           passes: int = 1, sampler_kind: str = "independent"):
    """Render an image -> (H, W, 3) linear sRGB, in RGB mode or, with a
    sunsky state precomputed in spectral mode (or a UniformEnv or no
    environment), hero-wavelength spectral mode. The arguments bind
    positionally as the reference package's `render`.

    `key` is an integer seed (one pass: the reference's
    `key_data(fold_in(key, 0))[-1]`) or the reference key's two uint32
    words, with which the image is the reference's lane for lane;
    `passes` splits spp into passes of spp // passes samples, each keyed
    on `fold_in(key, pass)`, accumulated in one film. `max_depth` counts
    vertices excluding the camera (2 = direct illumination)."""
    kinds = bsdf_mod.table_kinds(scene.bsdfs)
    accum = None
    for seed in _pass_seeds(key, passes):
        a = _render_impl(scene, sensor, film, seed, spp // passes, max_depth,
                         rr_depth, mode, sampler_kind, kinds)
        accum = a if accum is None else accum + a
    return film_mod.develop(accum)


def render_moments(scene: Scene, sensor, film: film_mod.Film, key,
                   spp: int = 16, max_depth: int = 2, rr_depth: int = 1000,
                   mode: str = "rgb", sampler_kind: str = "independent"):
    """Mean image and per-pixel second moment E[x^2] -> two (H, W, C)
    images (the reference's `moment.cpp` integrator, which builds the
    Z-test reference data; variance = m2 - mean^2).

    The wavefront path's lanes (K2/K3 on the card, K10/K11 in spectral
    mode) are accumulated with their squares into a box film of 2C
    channels, in the spp chunks `render_rows` takes, so the mean is
    bitwise the developed `render_rows` image at the same seed. `key` as
    in `render` (one pass: the reference's `render_moments(..., key)`
    uses `key_data(fold_in(key, 0))[-1]`)."""
    seed = _pass_seeds(key, 1)[0]
    kinds = bsdf_mod.table_kinds(scene.bsdfs)
    scene = with_mesh_tables(scene, False)
    n_rows = film_mod.crop_extent(film)[3]
    spp_chunk = _spp_chunk(film, spp, n_rows, 1 << 20)
    c = film.n_channels
    accum = None
    for spp0 in range(0, spp, spp_chunk):
        radiance = _lane_radiance(scene, sensor, film, seed, spp, spp0,
                                  spp_chunk, max_depth, rr_depth, mode, 0,
                                  n_rows, sampler_kind, kinds)
        block = film_mod.Film(n_rows, film_mod.crop_extent(film)[2], c)
        # the sums of the lanes and of their squares, each reduced as
        # render_rows reduces its lanes, then one 2C-channel accumulation
        a1 = film_mod.splat_ordered(block, radiance, spp_chunk)
        a2 = film_mod.splat_ordered(block, radiance * radiance, spp_chunk)
        a = torch.cat([a1[..., :c], a2[..., :c], a1[..., c:]], -1)
        accum = a if accum is None else accum + a
    img = film_mod.develop(accum)
    return img[..., :c], img[..., c:]
