"""Integrator: the wavefront path tracer and the megakernel gate.

The PyTorch counterpart of `tpusky/render/integrator.py`, restricted to
what the headline RGB, spectral and mesh renders need: analytic shapes,
triangle meshes (kernel K14 on the card), diffuse and rough-conductor
materials, the sunsky environment, NEE + MIS
(power heuristic, beta = 2, reference `path.cpp:321`), no Russian
roulette, no delta or area lights. Spectral mode is hero-wavelength
transport: 4 wavelengths per path from `sample_rgb_spectrum`, developed
to sRGB per lane (the specfilm branches are not ported). Anything else
raises NotImplementedError.

The whole wavefront (H * W * spp lanes) is one set of tensors and the
bounce loop is a Python loop with per-lane active masks. Uniforms come
from the counter-hash sampler keyed on the global lane index, so an image
does not depend on spp chunking.

`_render_impl` runs an eligible scene on the card through the fused
megakernel K4 (`ops/cuda/megakernel.py`), and every other scene through
the wavefront path, whose sky lookups are kernels K2 and K3 (K10 and K11
in spectral mode) and whose mesh queries are kernel K14 for CUDA tensors.
`plain=True` runs the wavefront path with the plain sunsky and mesh
functions on any device: the reference the kernels are held against.

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

import torch

from ..models.sunsky.model import SunskyState
from ..ops import spectrum
from ..ops.math import Frame, dot, norm
from . import bsdf as bsdf_mod
from . import emitters as em
from . import film as film_mod
from . import sensors as sensors_mod
from .mesh import mesh_intersect
from .sampler import lane_samples
from .scene import Scene, scene_occluded, with_mesh_tables
from .shapes import KINDS, ray_intersect

_SHADOW_EPS = 1e-3
_DIFFUSE_ONLY = ((bsdf_mod.DIFFUSE,), False)
_KINDS = (_DIFFUSE_ONLY, ((bsdf_mod.ROUGH_CONDUCTOR,), False),
          ((bsdf_mod.DIFFUSE, bsdf_mod.ROUGH_CONDUCTOR), False))
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
    if not isinstance(scene.env, SunskyState):
        raise NotImplementedError("only the sunsky environment is ported")
    if (mode == "spectral") != (scene.env.sun_ld is not None):
        raise ValueError(f"a {mode} render needs a sunsky state "
                         f"precomputed in {mode} mode")
    if max_depth < 1:
        raise NotImplementedError(f"max_depth {max_depth}")
    if rr_depth <= max_depth - 1:
        raise NotImplementedError("Russian roulette is not ported")
    if kinds is not None and kinds not in _KINDS:
        raise NotImplementedError(f"material kinds {kinds}")


def _scene_intersect(scene: Scene, o, d, plain: bool):
    """Closest hit over the analytic shapes and the mesh -> (t, p, ng,
    material index, hit). A mesh hit closer than the shapes' takes the
    hit point o + t d, the interpolated shading normal as ng and the
    triangle's material (`tpusky/render/integrator.py:274-289, 410-411`)."""
    t, p, ng, shape_idx, hit = ray_intersect(scene.shapes, o, d)
    mat_idx = scene.shapes.bsdf_idx[shape_idx.clamp(min=0)]
    if scene.mesh is not None:
        tm, nm, matm, _, _, _, hitm = mesh_intersect(
            scene.mesh, o, d, plain=plain, tables=scene.mesh_tables)
        use_mesh = hitm & (tm < t)
        t = torch.where(use_mesh, tm, t)
        p = torch.where(use_mesh[..., None], o + tm[..., None] * d, p)
        ng = torch.where(use_mesh[..., None], nm, ng)
        mat_idx = torch.where(use_mesh, matm, mat_idx)
        hit = hit | hitm
    return t, p, ng, mat_idx, hit


def _path_sample(scene: Scene, o, d, smp: _SamplerCtx, max_depth: int,
                 rr_depth: int, mode: str, kinds=None, plain=False,
                 wavelengths=None):
    """Estimate radiance along primary rays o, d -> (N, C): C = 3 in RGB
    mode, W at the lanes' hero wavelengths (N, W) in spectral mode.

    max_depth counts path vertices like the reference (2 == direct
    illumination). Sample placement and every pdf in a MIS weight or an
    estimator's denominator are detached exactly where the reference
    package's `_path_sample` detaches them (`prb.py:147-160`); each
    `.detach()` below names its line in `tpusky/render/integrator.py`."""
    _check_slice(scene, max_depth, rr_depth, mode, kinds)
    n = o.shape[0]
    dev = o.device
    env, env_to_world = scene.env, scene.env_to_world
    n_chan = 3 if wavelengths is None else wavelengths.shape[-1]
    throughput = torch.ones((n, n_chan), device=dev)
    result = torch.zeros((n, n_chan), device=dev)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    prev_bsdf_pdf = torch.ones((n,), device=dev)
    prev_bsdf_delta = torch.ones((n,), dtype=torch.bool, device=dev)

    def env_hit(active, o, d, throughput, prev_bsdf_pdf, prev_bsdf_delta):
        """(hit geometry, radiance of escaped lanes weighted by MIS)."""
        geo = _scene_intersect(scene, o, d, plain)
        env_l, em_pdf = em.env_eval_pdf(env, d, env_to_world, mode,
                                        pdf_detached=True, plain=plain,
                                        wavelengths=wavelengths)
        em_pdf = torch.where(prev_bsdf_delta, 0.0, em_pdf)
        # sg(em_pdf): tpusky/render/integrator.py:371 (loop), :765 (last)
        mis_em = _mis_weight(prev_bsdf_pdf, em_pdf.detach())
        escaped = active & ~geo[4]
        return geo, torch.where(escaped[..., None],
                                throughput * env_l * mis_em[..., None], 0.0)

    def offset(p, ng, dirs):
        return p + torch.sign(dot(ng, dirs))[..., None] * ng * (
            _SHADOW_EPS * norm(p, keepdim=True).clamp(min=1.0))

    for depth in range(max_depth - 1):
        (t, p, ng, mat_idx, hit), contrib = env_hit(
            active, o, d, throughput, prev_bsdf_pdf, prev_bsdf_delta)
        result = result + contrib
        active = active & hit
        frame = Frame(ng)
        wi_local = frame.to_local(-d)

        # ---- next-event estimation toward the environment ----
        u_nee = smp.next(3 * depth + 0, 2).detach()          # :464
        d_e, l_e, pdf_e = em.env_sample_eval(env, env_to_world, u_nee, mode,
                                             pdf_detached=True, plain=plain,
                                             wavelengths=wavelengths)
        pdf_e = pdf_e.detach()                                # :470
        f_val, pdf_b = bsdf_mod.eval_pdf(
            scene.bsdfs, mat_idx, wi_local, frame.to_local(d_e), wavelengths,
            kinds=kinds)
        occluded = scene_occluded(scene, offset(p, ng, d_e), d_e, torch.inf,
                                  plain=plain)
        mis_nee = _mis_weight(pdf_e, pdf_b.detach())          # :480
        contrib = (throughput * f_val * l_e
                   * (mis_nee / pdf_e.clamp(min=1e-20))[..., None])
        ok = active & ~occluded & (pdf_e > 0.0)
        result = result + torch.where(ok[..., None], contrib, 0.0)

        # ---- BSDF sampling for the next bounce ----
        u_bsdf = smp.next(3 * depth + 1, 3).detach()         # :618
        wo_local, weight, pdf_b, is_delta = bsdf_mod.sample(
            scene.bsdfs, mat_idx, wi_local, u_bsdf[..., :2], u_bsdf[..., 2],
            wavelengths, kinds=kinds)
        d_next = frame.to_world(wo_local.detach())            # :622
        active = active & (pdf_b > 0.0)
        keep = active[..., None]
        o = torch.where(keep, offset(p, ng, d_next), o)
        d = torch.where(keep, d_next, d)
        throughput = torch.where(keep, throughput * weight, throughput)
        prev_bsdf_pdf = torch.where(active, pdf_b.detach(),  # :668
                                    prev_bsdf_pdf)
        prev_bsdf_delta = torch.where(active, is_delta, prev_bsdf_delta)

    # final vertex: only the emitter-hit contribution remains
    _, contrib = env_hit(active, o, d, throughput, prev_bsdf_pdf,
                         prev_bsdf_delta)
    return result + contrib


def _lane_radiance(scene, sensor, film_cfg, seed, spp, spp0, spp_chunk,
                   max_depth, rr_depth, mode, row0, n_rows,
                   sampler_kind="independent", kinds=None, plain=False):
    """Per-lane radiance (n_rows * W * spp_chunk, 3) of `spp_chunk` of the
    `spp` samples for a block of film rows, lanes pixel-ordered; in
    spectral mode the lanes' spectral radiance developed to linear sRGB.
    Non-finite values are zeroed."""
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
                            wavelengths=wavelengths)
        radiance = spectrum.spectrum_to_srgb(spec * wl_weight, wavelengths)
    else:
        radiance = _path_sample(scene, o, d, smp, max_depth, rr_depth, mode,
                                kinds=kinds, plain=plain)
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


def render_rows(scene, sensor, film_cfg, seed, spp, max_depth, rr_depth,
                mode, row0, n_rows, max_lanes=(1 << 20),
                sampler_kind="independent", kinds=None, plain=False):
    """Render a block of film rows -> (n_rows, W, 4), bounding the live
    wavefront to `max_lanes` lanes by looping over spp chunks (the
    reference bounds it the same way, `integrator.cpp:247-265`). On the
    card K14's mesh tables are built once for all its queries."""
    scene = with_mesh_tables(scene, plain)
    w = film_mod.crop_extent(film_cfg)[2]
    chunk_cap = max(1, min(spp, max_lanes // max(n_rows * w, 1)))
    # smallest divisor-of-spp chunking whose chunk fits the lane budget
    spp_chunk = next(c for c in range(chunk_cap, 0, -1) if spp % c == 0)
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
    """The reference package's static eligibility rules (its backend test
    is the device test in `_megakernel_ok`)."""
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
    # K4 intersects analytic shapes only
    if scene.mesh is not None:
        return False
    if kinds != _DIFFUSE_ONLY:
        return False
    if any(k not in KINDS for k in scene.shapes.kind):
        return False
    if not isinstance(sensor, sensors_mod.Perspective):
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


def render(scene: Scene, sensor, film: film_mod.Film, seed: int,
           spp: int = 16, max_depth: int = 2, rr_depth: int = 1000,
           mode: str = "rgb", sampler_kind: str = "independent"):
    """Render an image -> (H, W, 3) linear sRGB, in RGB mode or, with a
    sunsky state precomputed in spectral mode, hero-wavelength spectral
    mode.

    `seed` is the sampler's integer seed: the reference package's
    `render(..., key)` uses `key_data(fold_in(key, 0))[-1]` for its single
    pass. `max_depth` counts vertices excluding the camera (2 = direct
    illumination)."""
    accum = _render_impl(scene, sensor, film, seed, spp, max_depth, rr_depth,
                         mode, sampler_kind, bsdf_mod.table_kinds(scene.bsdfs))
    return film_mod.develop(accum)
