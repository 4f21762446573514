"""Integrator: the wavefront path tracer and the megakernel gate.

The PyTorch counterpart of `tpusky/render/integrator.py`: analytic
shapes (sphere, rectangle, disk, cube, cylinder), triangle meshes
(kernel K14 on the card), an SDF grid (`render/sdf.py`, its gradient
reaching the grid's values) and curves (`render/curve.py`, hair shaded in
the fiber frame of the winning segment's tangent), every material kind
(diffuse, rough conductor, conductor, dielectric, plastic, rough
dielectric, null, thin dielectric, rough plastic, principled, blend,
principledthin, hair, the measured BRDF, and the polarized kinds' scalar
radiometry: pplastic, polarizer, retarder, circular, the measured pBRDF;
their Stokes transport is `render/polarized.py`'s `render_stokes`) with
opacity masks, textures and normal maps (`render/texture.py`: uv at
analytic and mesh hits, vertex colours), the sunsky, constant, uniform
and bitmap (envmap) environments or none, area emitters, point,
directional and spot lights, NEE + MIS (power heuristic, beta = 2,
reference `path.cpp:321`), Russian roulette and participating media
(`render/medium.py`: free flight over one or more convex regions,
homogeneous or a density grid, every phase function; a scattering lane
samples the environment and its phase function). A medium beside area
or delta lights (R13) and a spectral render of a medium of more than one
channel (R14) raise. The environments and the lobes enter the path only through
`emitters.env_*` and `bsdf.eval_pdf` / `bsdf.sample`, as in the
reference. Up to two delta lights are each connected at every
vertex; more are sampled one a vertex by their weights
(`scene.cpp:100-119`). Spectral mode is hero-wavelength transport: 4
wavelengths per path, from `sample_rgb_spectrum` and developed to sRGB
per lane, or for a specfilm (`film.bands` or `film.srfs`) drawn over the
bands or from the combined sensor responses and accumulated into the
film's channels; the RGB emitters (area, point, directional, spot, a
ConstantEnv) are upsampled with rgb2spec, fitted once a render
(`scene.with_emitter_coeffs`), and an envmap shows its texels' fitted
spectra. Every sensor, sampler and reconstruction filter of the
reference is here. Anything else raises NotImplementedError.

The whole wavefront (H * W * spp lanes) is one set of tensors and the
bounce loop is a Python loop with per-lane active masks. Uniforms come
from the sampler (`render/sampler.py`) keyed on the global lane index, so
an image does not depend on spp chunking. `render(passes=n)` folds the
pass index into the reference's threefry key on the host
(`sampler.fold_in`). A filter other than the box splats the lanes into
the film without atomics (`film.splat`), so every image is bitwise
reproducible.

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
(`tpusky/render/integrator.py:989-1026`). Forward mode
(`torch.autograd.forward_ad`, `ad/integrators.py::render_forward`) takes
the same routes: each kernel's `Function` keeps its primal and takes its
tangent by forward-mode AD of its plain version, and `_Megakernel`
replays the wavefront path for K4's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from ..models.sunsky.model import SunskyState
from ..ops import spectrum
from ..ops.distr import discrete_sample_reuse, make_discrete
from ..ops.math import Frame, dot, norm
from ..ops.rgb2spec import eval_emitter_coeff_spectrum
from . import bsdf as bsdf_mod
from . import emitters as em
from . import film as film_mod
from . import medium as medium_mod
from . import sensors as sensors_mod
from . import spectra
from .curve import curve_intersect
from .mesh import mesh_interp_color, mesh_interp_uv, mesh_intersect
from .sampler import fold_in, key_seed, lane_samples
from .scene import (Scene, n_delta_lights, scene_occluded, table_len,
                    with_emitter_coeffs, with_mesh_tables)
from .sdf import sdf_intersect
from .shapes import DISK, RECTANGLE, SPHERE, ray_intersect
from .texture import eval_texture, table_texture_kinds

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
    """Per-render sampler context bound to lane identities; `key` an
    integer seed or the pass key's two uint32 words."""

    def __init__(self, kind, key, pixel_idx, sample_idx, spp):
        self.kind = kind
        self.key = key
        self.pixel_idx = pixel_idx
        self.sample_idx = sample_idx
        self.spp = spp

    def next(self, dim, n):
        return lane_samples(self.kind, self.key, self.pixel_idx,
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
    if max_depth < 1:
        raise NotImplementedError(f"max_depth {max_depth}")
    if kinds is not None:
        bsdf_mod.check_kinds(kinds[0])
        bsdf_mod.check_datasets(kinds[0], scene.bsdfs.measured,
                                scene.bsdfs.measured_pol)
    if scene.medium is not None:
        # R13: the reference's medium vertex samples the environment
        # alone (`tpusky/render/integrator.py:627-653`; its area and delta
        # connections skip scattering lanes, :403-406), so area and delta
        # light scattered in a medium comes out too dark or not at all
        if table_len(scene.area_emitter_shapes) or n_delta_lights(scene):
            raise NotImplementedError(
                "R13: a medium beside area, point, directional or spot "
                "emitters (the reference's medium vertex samples only the "
                "environment)")
        # R14: the reference's spectral path multiplies a medium's
        # channels with the hero wavelengths and fails on more than one
        if mode == "spectral" and medium_mod.n_channels(scene.medium) > 1:
            raise NotImplementedError(
                "R14: a spectral render of a medium with more than one "
                "channel")


def _scene_hit(scene: Scene, o, d, plain: bool, textured: bool = False,
               fiber: bool = False):
    """Closest hit over the analytic shapes, the mesh, the SDF grid and the
    curves -> (t, p, ng, shape index (-2 on a mesh hit, -3 on the SDF, -4
    on a curve), material index, hit); with `textured` also the hit's uv
    (..., 2) and vertex colour (..., 3) (None where the mesh has none, 0
    off the mesh); with `fiber` then the lanes on a curve and the winning
    segment's unit tangent (None without curves). A closer hit takes the
    hit point o + t d, its normal as ng and its material; a mesh hit also
    the interpolated uv and colour (`tpusky/render/integrator.py:274-327,
    410-415`)."""
    if textured:
        t, p, ng, uv, shape_idx, hit = ray_intersect(scene.shapes, o, d,
                                                     uv=True)
    else:
        t, p, ng, shape_idx, hit = ray_intersect(scene.shapes, o, d)
    mat_idx = scene.shapes.bsdf_idx[shape_idx.clamp(min=0)]
    attr = None
    if scene.mesh is not None:
        tm, nm, matm, b1, b2, tri, hitm = mesh_intersect(
            scene.mesh, o, d, plain=plain, tables=scene.mesh_tables)
        use_mesh = hitm & (tm < t)
        t = torch.where(use_mesh, tm, t)
        # a finite t off the mesh: o + inf * d would make the direction's
        # gradient 0 * inf = NaN there (the reference's analytic shapes do
        # the same, `tpusky/render/shapes.py:224-227`; R12)
        p = torch.where(use_mesh[..., None],
                        o + torch.where(use_mesh, tm, 0.0)[..., None] * d, p)
        ng = torch.where(use_mesh[..., None], nm, ng)
        shape_idx = torch.where(use_mesh, -2, shape_idx)
        mat_idx = torch.where(use_mesh, matm, mat_idx)
        hit = hit | hitm
        if textured:
            uv = torch.where(use_mesh[..., None],
                             mesh_interp_uv(scene.mesh, tri, b1, b2), uv)
            if scene.mesh.col is not None:
                attr = torch.where(use_mesh[..., None], mesh_interp_color(
                    scene.mesh, tri, b1, b2), 0.0)

    def closer(t_k, n_k, hit_k, index, mat_k):
        use = hit_k & (t_k < t)
        # o + t d with a finite t off the shape (R12, as above)
        p_k = o + torch.where(use, t_k, 0.0)[..., None] * d
        return (use, torch.where(use, t_k, t),
                torch.where(use[..., None], p_k, p),
                torch.where(use[..., None], n_k, ng),
                torch.where(use, index, shape_idx),
                torch.where(use, mat_k, mat_idx), hit | use)
    if scene.sdf is not None:
        ts, ns, hs = sdf_intersect(scene.sdf, o, d)
        _, t, p, ng, shape_idx, mat_idx, hit = closer(
            ts, ns, hs, -3, scene.sdf.bsdf_idx)
    on_curve = tangent = None
    if scene.curve is not None:
        tc, nc, matc, hc, tangent = curve_intersect(scene.curve, o, d)
        on_curve, t, p, ng, shape_idx, mat_idx, hit = closer(
            tc, nc, hc, -4, matc)
    out = (t, p, ng, shape_idx, mat_idx, hit)
    if textured:
        out += (uv, attr)
    if fiber:
        out += (on_curve, tangent)
    return out


def _scene_intersect(scene: Scene, o, d, plain: bool):
    """`_scene_hit` without the shape index -> (t, p, ng, material index,
    hit)."""
    t, p, ng, _, mat_idx, hit = _scene_hit(scene, o, d, plain)
    return t, p, ng, mat_idx, hit


def _fiber_frame(frame: Frame, on_curve, tangent, ng, kind):
    """`frame` with the hair lanes on a curve in the fiber frame: +y the
    segment's tangent, +z ng projected off it, +x their cross product
    (`hair.cpp:140-149`; `tpusky/render/integrator.py:444-459`)."""
    z_h = ng - (ng * tangent).sum(-1, keepdim=True) * tangent
    z_h = z_h / torch.linalg.vector_norm(z_h, dim=-1,
                                         keepdim=True).clamp(min=1e-9)
    m = (on_curve & (kind == bsdf_mod.HAIR))[..., None]
    out = Frame.__new__(Frame)
    out.s = torch.where(m, torch.linalg.cross(tangent, z_h, dim=-1), frame.s)
    out.t = torch.where(m, tangent, frame.t)
    out.n = torch.where(m, z_h, frame.n)
    return out


def _offset(p, ng, dirs):
    """A shadow or continuation ray's origin: p moved off the surface
    along +-ng, toward dirs."""
    return p + torch.sign(dot(ng, dirs))[..., None] * ng * (
        _SHADOW_EPS * norm(p, keepdim=True).clamp(min=1.0))


def _light_rows(x, device):
    """An optional (N, 6) light table, empty for None."""
    return torch.zeros((0, 6), device=device) if x is None else x


def _spot_ratio(light, fall):
    """A spot's falloff and texture as a scalar on its spectrum
    (`tpusky/render/integrator.py:585-589`)."""
    return fall.sum(-1) / light.intensity.sum().clamp(min=1e-12)


def _delta_lights_unrolled(scene, p, ng, frame, wi_local, mat_idx,
                           throughput, active, kinds, plain, wavelengths,
                           refl_tex):
    """Each delta light connected at every vertex (at most 2 lights;
    `tpusky/render/integrator.py:523-600`); in spectral mode each
    emits its rgb2spec spectrum."""
    acc = torch.zeros_like(throughput)
    cf = scene.emitter_coeffs

    def connect(d_l, maxt):
        """(f cos toward d_l, lanes the light reaches)."""
        f_l, _ = bsdf_mod.eval_pdf(scene.bsdfs, mat_idx, wi_local,
                                   frame.to_local(d_l), wavelengths,
                                   kinds=kinds, refl_tex=refl_tex)
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
        i_l = (pl[li, 3:] if wavelengths is None else
               eval_emitter_coeff_spectrum(cf.point[li], wavelengths))
        acc = acc + torch.where(ok, throughput * f_l * i_l / dist2, 0.0)
    dl = _light_rows(scene.directional_lights, p.device)
    for li in range(dl.shape[0]):
        d_l = -dl[li, :3]
        d_l = (d_l / norm(d_l)).expand(p.shape)
        f_l, ok = connect(d_l, torch.inf)
        e_l = (dl[li, 3:] if wavelengths is None else
               eval_emitter_coeff_spectrum(cf.directional[li],
                                           wavelengths))
        acc = acc + torch.where(ok, throughput * f_l * e_l, 0.0)
    for si, light in enumerate(scene.spot_lights):
        d_l, dist, dist2 = toward(light.position)
        f_l, ok = connect(d_l, dist * (1 - 1e-3))
        i_l = em.spot_falloff(light, -d_l)
        if wavelengths is not None:
            i_l = (eval_emitter_coeff_spectrum(cf.spot[si], wavelengths)
                   * _spot_ratio(light, i_l)[..., None])
        acc = acc + torch.where(ok, throughput * f_l * i_l / dist2, 0.0)
    return acc


def _delta_lights_single_sample(scene, u_pick, p, ng, frame, wi_local,
                                mat_idx, throughput, active, kinds, plain,
                                wavelengths, refl_tex):
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
                               frame.to_local(d_l), wavelengths, kinds=kinds,
                               refl_tex=refl_tex)
    occ = scene_occluded(scene, _offset(p, ng, d_l), d_l, maxt, plain=plain)
    fall = intensity
    ratio = torch.ones_like(dist)
    for si, light in enumerate(spots):
        pick = idx == n_pt + n_dir + si
        f_s = em.spot_falloff(light, -d_l)
        fall = torch.where(pick[..., None], f_s, fall)
        ratio = torch.where(pick, _spot_ratio(light, f_s), ratio)
    if wavelengths is None:
        intensity = torch.where(is_spot[..., None], fall, intensity)
    else:
        cf = scene.emitter_coeffs
        cf_rows = torch.cat([torch.zeros((n, 4), device=dev) if t is None
                             else t for t, n in ((cf.point, n_pt),
                                                 (cf.directional, n_dir),
                                                 (cf.spot, len(spots)))], 0)
        intensity = (eval_emitter_coeff_spectrum(cf_rows[idx], wavelengths)
                     * torch.where(is_spot, ratio, 1.0)[..., None])
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
    lanes it ends.

    In a medium each segment draws a free flight over the regions
    (`medium.stack_sample`): emitter hits take the segment's
    transmittance, the surface vertex the pass-through weight, and a
    lane that scatters does next-event estimation toward the environment
    and continues along a phase sample instead (:338-356, :627-669)."""
    _check_slice(scene, max_depth, rr_depth, mode, kinds)
    if wavelengths is not None:
        scene = with_emitter_coeffs(scene)
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
    # textures: the kinds present and whether a row has a normal map, from
    # the tables' host copies (`tpusky/render/integrator.py:1098-1101`)
    textured = scene.textures is not None
    tkinds = table_texture_kinds(scene.textures)
    nmaps = textured and bsdf_mod.table_normal_maps(scene.bsdfs)
    media = no_end = None
    if scene.medium is not None:
        media = medium_mod.as_stack(scene.medium)
        no_end = torch.full((n,), torch.inf, device=dev)

    def emitter_hits(result, active, o, d, throughput, prev_bsdf_pdf,
                     prev_bsdf_delta, geo, t_seg=None):
        """result plus the escaped lanes' environment radiance and the
        area emitters' radiance at hits (`geo`), each weighted by MIS
        against the previous BSDF sample and by the medium's
        transmittance `t_seg` where there is one."""
        p, ng, shape_idx, hit = geo[1], geo[2], geo[3], geo[5]
        if t_seg is not None:
            throughput = throughput * t_seg
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
            rows = shape_idx.clamp(min=0)
            if wavelengths is None:
                area_l = scene.area_radiance[rows]
            elif n_area > 0:        # rgb2spec spectra (:383, :770-778)
                area_l = eval_emitter_coeff_spectrum(
                    scene.emitter_coeffs.area[rows], wavelengths)
            else:
                area_l = scene.area_radiance[rows].mean(-1, keepdim=True)
            contrib = throughput * area_l
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
        return result

    # the fiber frame where a hair row can be hit on a curve
    hair = (scene.curve is not None and bsdf_mod.HAIR in (
        bsdf_mod.table_kinds(scene.bsdfs) if kinds is None else kinds)[0])
    for depth in range(max_depth - 1):
        geo = _scene_hit(scene, o, d, plain, textured, fiber=hair)
        t, p, ng, mat_idx, hit = geo[0], geo[1], geo[2], geo[4], geo[5]
        t_seg, thr_s = None, throughput
        if media is not None:
            # free flight over the segment up to the hit (:338-356)
            u_dist = smp.next(100_000 + 4 * depth,
                              len(media)).detach()           # :342
            (m_scat, t_scat, reg_oh, t_seg, w_pass,
             w_scat) = medium_mod.stack_sample(
                media, o, d, torch.where(hit, t, torch.inf), u_dist)
            med_scatter = active & m_scat
            # the surface vertex: attenuated by the pass-through weight,
            # and not reached where the lane scatters (:400-406)
            thr_s = throughput * w_pass
        result = emitter_hits(result, active, o, d, throughput,
                              prev_bsdf_pdf, prev_bsdf_delta, geo, t_seg)
        active = active & hit
        if media is not None:
            active = active & ~med_scatter
        frame = place = Frame(ng)
        # the textured reflectance, once a vertex, for every BSDF query
        # there (:417-424)
        refl_tex = None
        if textured:
            uv, attr = geo[6], geo[7]
            refl_tex = eval_texture(scene.textures,
                                    scene.bsdfs.tex_idx[mat_idx], uv,
                                    wavelengths, p=p, attr=attr,
                                    tkinds=tkinds)
        if nmaps:
            # the normal-mapped shading frame; ng still sets the offsets
            # and the facing tests (:428-444, `normalmap.cpp`)
            n_rgb, n_has = eval_texture(scene.textures,
                                        scene.bsdfs.normal_tex_idx[mat_idx],
                                        uv, None, p=p, attr=attr,
                                        tkinds=tkinds)
            n_loc = 2.0 * n_rgb - 1.0
            n_loc = n_loc / norm(n_loc, keepdim=True).clamp(min=1e-6)
            frame = Frame(torch.where(n_has[..., None],
                                      place.to_world(n_loc), ng))
            # the continuation's frame: the map places the sample, so its
            # gradient stops there, as the sample's does (R12: Mitsuba's
            # PRB detaches the whole ray; through the reference's it
            # reaches the next hit, NaN at o + inf * d on a mesh miss)
            place = Frame(torch.where(n_has[..., None],
                                      place.to_world(n_loc.detach()), ng))
        if hair:
            fiber = (geo[-2], geo[-1], ng, scene.bsdfs.kind[mat_idx])
            frame, place = (_fiber_frame(f, *fiber) for f in (frame, place))
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
                wavelengths, kinds=kinds, refl_tex=refl_tex)
            off_e = _offset(p, ng, d_e)
            occluded = scene_occluded(scene, off_e, d_e, torch.inf,
                                      plain=plain)
            mis_nee = _mis_weight(pdf_e, pdf_b.detach())      # :480
            contrib = thr_s * f_val * l_e
            if media is not None:                             # :482
                contrib = contrib * medium_mod.stack_transmittance(
                    media, off_e, d_e, no_end)
            contrib = contrib * (mis_nee / pdf_e.clamp(min=1e-20))[..., None]
            ok = active & ~occluded & (pdf_e > 0.0)
            result = result + torch.where(ok[..., None], contrib, 0.0)

        # ---- next-event estimation toward the area emitters ----
        if n_area > 0:
            u_area = smp.next(3 * depth + 3, 3).detach()     # :490
            d_a, dist_a, pdf_a, l_a, _, emit_a = em.area_sample_direction(
                scene, p, u_area[..., :2], u_area[..., 2])
            d_a, pdf_a = d_a.detach(), pdf_a.detach()         # :494-495
            if wavelengths is not None:                       # :496-497
                l_a = eval_emitter_coeff_spectrum(
                    scene.emitter_coeffs.area[emit_a], wavelengths)
            f_a, pdf_b_a = bsdf_mod.eval_pdf(
                scene.bsdfs, mat_idx, wi_local, frame.to_local(d_a),
                wavelengths, kinds=kinds, refl_tex=refl_tex)
            # the shadow ray starts along itself (the reference's
            # spawn_ray_to): an offset along the normal would shorten the
            # distance to the emitter point unboundedly at grazing angles
            eps_a = _SHADOW_EPS * norm(p).clamp(min=1.0)
            occ_a = scene_occluded(scene, p + eps_a[..., None] * d_a, d_a,
                                   (dist_a - eps_a) * (1.0 - 1e-3),
                                   plain=plain)
            mis_a = _mis_weight(pdf_a, pdf_b_a.detach())      # :517
            contrib_a = (thr_s * f_a * l_a
                         * (mis_a / pdf_a.clamp(min=1e-20))[..., None])
            ok_a = active & ~occ_a & (pdf_a > 0.0)
            result = result + torch.where(ok_a[..., None], contrib_a, 0.0)

        # ---- delta emitters (point / directional / spot) ----
        if n_delta > 2:
            u_pick = smp.next(300_000 + depth, 1)[..., 0].detach()  # :610
            result = result + _delta_lights_single_sample(
                scene, u_pick, p, ng, frame, wi_local, mat_idx, thr_s,
                active, kinds, plain, wavelengths, refl_tex)
        elif n_delta > 0:
            result = result + _delta_lights_unrolled(
                scene, p, ng, frame, wi_local, mat_idx, thr_s, active,
                kinds, plain, wavelengths, refl_tex)

        # ---- BSDF sampling for the next bounce ----
        u_bsdf = smp.next(3 * depth + 1, 3).detach()         # :618
        wo_local, weight, pdf_b, is_delta = bsdf_mod.sample(
            scene.bsdfs, mat_idx, wi_local, u_bsdf[..., :2], u_bsdf[..., 2],
            wavelengths, kinds=kinds, refl_tex=refl_tex)
        d_next = place.to_world(wo_local.detach())            # :622
        thr_next = thr_s * weight
        active = active & (pdf_b > 0.0)
        o_next = _offset(p, ng, d_next)
        pdf_next, delta_next = pdf_b.detach(), is_delta       # :668

        if media is not None:
            # ---- a scatter in the medium (:627-669) ----
            p_m = o + t_scat[..., None] * d
            thr_m = throughput * w_scat
            if env is not None:
                u_nee_m = smp.next(100_000 + 4 * depth + 1,
                                   2).detach()                # :633
                d_me, l_me, pdf_me = em.env_sample_eval(
                    env, env_to_world, u_nee_m, wavelengths, mode,
                    pdf_detached=True, plain=plain)
                pdf_me = pdf_me.detach()                      # :637
                f_p = medium_mod.stack_phase_pdf(media, reg_oh, d, d_me)
                occ_m = scene_occluded(scene, p_m, d_me, torch.inf,
                                       plain=plain)
                mis_m = _mis_weight(pdf_me, f_p.detach())     # :644
                contrib_m = (thr_m * f_p[..., None] * l_me
                             * medium_mod.stack_transmittance(
                                 media, p_m, d_me, no_end)
                             * (mis_m / pdf_me.clamp(min=1e-20))[..., None])
                ok_m = med_scatter & ~occ_m & (pdf_me > 0.0)
                result = result + torch.where(ok_m[..., None], contrib_m,
                                              0.0)
            u_ph = smp.next(100_000 + 4 * depth + 2, 2).detach()  # :650
            d_ph, pdf_ph = medium_mod.stack_phase_sample(media, reg_oh, d,
                                                         u_ph)
            # the two continuations merged (:655-669)
            m = med_scatter[..., None]
            o_next = torch.where(m, p_m, o_next)
            d_next = torch.where(m, d_ph.detach(), d_next)    # :653
            thr_next = torch.where(m, thr_m, thr_next)
            pdf_next = torch.where(med_scatter, pdf_ph.detach(), pdf_next)
            delta_next = delta_next & ~med_scatter
            active = active | med_scatter

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
        o = torch.where(keep, o_next, o)
        d = torch.where(keep, d_next, d)
        throughput = torch.where(keep, thr_next, throughput)
        prev_bsdf_pdf = torch.where(active, pdf_next, prev_bsdf_pdf)
        prev_bsdf_delta = torch.where(active, delta_next, prev_bsdf_delta)

    # final vertex: only the emitter-hit contributions remain, through
    # the medium's transmittance to the vertex (:748-755)
    geo = _scene_hit(scene, o, d, plain)
    t_fin = None
    if media is not None:
        t_fin = medium_mod.stack_transmittance(
            media, o, d, torch.where(geo[5], geo[0], torch.inf))
    return emitter_hits(result, active, o, d, throughput, prev_bsdf_pdf,
                        prev_bsdf_delta, geo, t_fin)


def _lane_radiance(scene, sensor, film_cfg, seed, spp, spp0, spp_chunk,
                   max_depth, rr_depth, mode, row0, n_rows,
                   sampler_kind="independent", kinds=None, plain=False,
                   rr_log=None, film_uv=False):
    """Per-lane radiance (n_rows * W * spp_chunk, C) of `spp_chunk` of the
    `spp` samples for a block of film rows, lanes pixel-ordered: the
    film's C channels, linear sRGB or, in spectral mode with a specfilm,
    its sensor responses or bands (`tpusky/render/integrator.py:
    816-892`). `seed` is the pass key (an integer seed or two uint32
    words). Non-finite values are zeroed. `rr_log` as in `_path_sample`;
    `film_uv=True` also returns the lanes' film positions (N, 2) in
    full-film pixels."""
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
    # the lens draw only where the sensor reads it: each dim has its own
    # stream, so skipping it moves no other sample
    u_lens = (smp.next(10_001, 2) if sensors_mod.takes_lens_sample(sensor)
              else None)
    pix = torch.stack([px_full.float() + u_pos[:, 0],
                       py_full.float() + u_pos[:, 1]], -1)
    o, d = sensors_mod.sample_ray(sensor, torch.stack(
        [pix[:, 0] / w, pix[:, 1] / h], -1), u_lens)

    def trace(wavelengths):
        return _path_sample(scene, o, d, smp, max_depth, rr_depth, mode,
                            kinds=kinds, plain=plain,
                            wavelengths=wavelengths, rr_log=rr_log)
    if mode != "spectral":
        radiance = trace(None)
    else:
        u_wl = smp.next(20_000, 1)[..., 0]
        if film_cfg.srfs is not None:
            # wavelengths from the combined sensor response, each channel
            # weighted by its own (`specfilm.cpp`; :827-841)
            wavelengths, wl_pdf = spectra.srf_sample_wavelengths(
                film_cfg.srfs, u_wl, _N_HERO)
            radiance = spectra.srf_accumulate(
                film_cfg.srfs, wavelengths,
                trace(wavelengths) / wl_pdf.clamp(min=1e-12))
        elif film_cfg.bands is not None:
            # uniform over the bands' range, each sample in its band,
            # per unit wavelength (:842-861)
            lo, hi = float(film_cfg.bands[0]), float(film_cfg.bands[-1])
            wavelengths = lo + (hi - lo) * spectrum.sample_shifted(
                u_wl, _N_HERO)
            edges = film_mod.band_edges(film_cfg.bands, o.device)
            radiance = film_mod.spectral_band_accumulate(
                wavelengths, trace(wavelengths) * (hi - lo),
                film_cfg.bands) / (edges[1:] - edges[:-1])
        else:
            # hero-wavelength transport developed to sRGB (:862-876)
            wavelengths, wl_weight = spectrum.sample_rgb_spectrum(
                spectrum.sample_shifted(u_wl, _N_HERO))
            radiance = spectrum.spectrum_to_srgb(
                trace(wavelengths) * wl_weight, wavelengths)
    radiance = torch.where(torch.isfinite(radiance), radiance, 0.0)
    return (radiance, pix) if film_uv else radiance


def _render_rows_chunk(scene, sensor, film_cfg, seed, spp, spp0, spp_chunk,
                       max_depth, rr_depth, mode, row0, n_rows,
                       sampler_kind="independent", kinds=None, plain=False):
    """Render `spp_chunk` of `spp` samples for a block of film rows ->
    accumulation block (n_rows, W, C+1), through the film's filter."""
    radiance, pix = _lane_radiance(
        scene, sensor, film_cfg, seed, spp, spp0, spp_chunk, max_depth,
        rr_depth, mode, row0, n_rows, sampler_kind, kinds, plain,
        film_uv=True)
    cx0, cy0, cw, _ = film_mod.crop_extent(film_cfg)
    block = film_mod.Film(n_rows, cw, film_cfg.n_channels, film_cfg.rfilter)
    if film_cfg.rfilter == "box":
        return film_mod.splat_ordered(block, radiance, spp_chunk)
    # the block's own coordinates (:886-892); the lanes stay in pixel order
    local = torch.stack([pix[:, 0] - float(cx0),
                         pix[:, 1] - float(cy0 + row0)], -1)
    return film_mod.splat(block, local, radiance, spp=spp_chunk)


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
    card K14's mesh tables are built once for all its queries; in
    spectral mode the emitters' rgb2spec coefficients are fitted once."""
    scene = with_mesh_tables(scene, plain)
    if mode == "spectral":
        scene = with_emitter_coeffs(scene)
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
    by the sunsky alone, untextured, in a vacuum (:955-958); it also
    refuses a scene whose shapes emit without an area emitter, which the
    reference lets through. It knows no mesh, SDF, curve, texture, medium
    or spot light."""
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
    if (scene.mesh is not None or scene.sdf is not None
            or scene.curve is not None or scene.spot_lights
            or scene.textures is not None or scene.medium is not None):
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
    with the incoming cotangent, and the tangent is forward-mode AD of
    the same replay (K2/K3 primal, their plain versions' tangents), so AD
    never touches K4 (`tpusky/ops/pallas/megakernel.py:28-30`). The
    scene's and the sensor's tensors come in flattened, since `apply`
    sees only the tensors passed to it."""

    @staticmethod
    def forward(ctx, cfg, struct, *leaves):
        from ..ops.cuda.megakernel import direct_rgb_megakernel
        ctx.cfg, ctx.struct, ctx.leaves = cfg, struct, leaves
        ctx.save_for_backward(*leaves)
        scene, sensor = _unflatten(struct, [t.detach() for t in leaves])
        film_cfg, seed, spp = cfg[:3]
        return direct_rgb_megakernel(scene, sensor, scene.env,
                                     key_seed(seed), spp, film_cfg.width,
                                     film_cfg.height)

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

    @staticmethod
    def jvp(ctx, *_tangents):
        film_cfg, seed, spp, max_depth, rr_depth, mode, sampler_kind, \
            kinds = ctx.cfg
        # the leaves, as the Function was given them, carry the tangents
        with fwAD._set_fwd_grad_enabled(True):
            scene, sensor = _unflatten(ctx.struct, ctx.leaves)
            accum = render_rows(scene, sensor, film_cfg, seed, spp,
                                max_depth, rr_depth, mode, 0,
                                film_mod.crop_extent(film_cfg)[3],
                                sampler_kind=sampler_kind, kinds=kinds)
            return fwAD.unpack_dual(accum).tangent


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


def _pass_keys(key, passes: int):
    """The sampler's key for each pass. `key` is an integer seed, the
    seed of one pass, or the two uint32 words of the reference package's
    threefry key (`np.asarray(jax.random.key_data(key))`), whose pass p
    the reference keys on `fold_in(key, p)` (its seed `key_data(...)[-1]`;
    `tpusky/render/integrator.py:1103-1108`, `render/sampler.py:133`)."""
    if isinstance(key, (int, np.integer)):
        if passes != 1:
            raise ValueError("render(passes > 1) takes the key's two uint32 "
                             "words, not an integer seed")
        return [int(key)]
    words = np.asarray(key, np.uint32).reshape(2)
    return [fold_in(words, p) for p in range(passes)]


def render(scene: Scene, sensor, film: film_mod.Film, key, spp: int = 16,
           max_depth: int = 2, rr_depth: int = 1000, mode: str = "rgb",
           passes: int = 1, sampler_kind: str = "independent"):
    """Render an image -> (H, W, C): linear sRGB in RGB mode or, with a
    sunsky state precomputed in spectral mode (or another environment or
    none), hero-wavelength spectral mode, developed to sRGB or to a
    specfilm's channels. The arguments bind positionally as the reference
    package's `render`; `sampler_kind` is one of `sampler.VALID_KINDS`.

    `key` is an integer seed (one pass: the reference's
    `key_data(fold_in(key, 0))[-1]`) or the reference key's two uint32
    words, with which the image is the reference's lane for lane (and
    which the `threefry` sampler needs); `passes` splits spp into passes
    of spp // passes samples, each keyed on `fold_in(key, pass)`,
    accumulated in one film. `max_depth` counts vertices excluding the
    camera (2 = direct illumination). In spectral mode the RGB emitters
    are fitted once for all passes."""
    kinds = bsdf_mod.table_kinds(scene.bsdfs)
    if mode == "spectral":
        scene = with_emitter_coeffs(scene)
    accum = None
    for seed in _pass_keys(key, passes):
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
    bitwise the developed `render_rows` image of a box film at the same
    seed. As the reference's (`tpusky/render/integrator.py:1036-1070`),
    it is box-filtered and, in spectral mode, sRGB whatever the film's
    filter and specfilm. `key` as in `render` (one pass: the reference's
    `render_moments(..., key)` uses `key_data(fold_in(key, 0))[-1]`)."""
    seed = _pass_keys(key, 1)[0]
    kinds = bsdf_mod.table_kinds(scene.bsdfs)
    scene = with_mesh_tables(scene, False)
    film = film._replace(rfilter="box", bands=None, srfs=None)
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
