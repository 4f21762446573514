"""Polarized light transport: Stokes-vector path tracing
(`tpusky/render/polarized.py`).

The counterpart of the reference's polarized variants (`*_polarized`) and
its `stokes` integrator (`src/integrators/stokes.cpp`):

* Radiance is a Stokes vector a channel and a path's throughput a Mueller
  matrix a channel: (N, C, 4) and (N, C, 4, 4). Each vertex's Mueller
  weight multiplies the throughput on the right (`path.cpp:275`), so the
  measured Stokes vector is T @ s_emitted, the camera side applied last.
* Every emitter is unpolarized. Polarization comes from the kinds that
  know of it: the conductors and the smooth dielectric (polarized
  Fresnel, `conductor.cpp:272-302`, `dielectric.cpp:294-340`), pplastic
  (`pplastic.cpp:280-369`) and the filters (polarizer, retarder,
  circular). Every other kind is an ideal depolarizer of its scalar
  value, the fallback of the reference's other plugins.
* Pdfs, sampling and the S0 magnitudes are the scalar BSDF's
  (`render/bsdf.py`): a polarizing lobe's Mueller weight is its Fresnel
  matrix scaled by scalar weight / M[0, 0], so S0 follows the scalar
  transport and S1..S3 carry the exact polarized Fresnel ratios
  (pplastic's eval is its own Mueller form, as the reference's).
* Matrices are built in the local shading frame for the implicit bases of
  (-wo, wi) and carried to the world bases by `mueller.to_world_mueller`.
  The next-event strategies need only the first column of T @ M_world
  (an unpolarized source), and the rotation to the world's input basis
  leaves that column as it is, so they take T @ R_out (one product a
  vertex, R_out shared by every strategy) times M_local's first column.

The sunsky's lookups are the kernels K2 and K3 (K10 and K11 in spectral
mode) and the mesh's closest hits and shadow rays K14 for CUDA tensors,
through `emitters.env_*` and `render/mesh.py`, as in the scalar path;
everything else is plain tensor code on any device. `plain=True` runs the
plain versions of those kernels on any device. The sky's pdfs enter
detached, so a gradient on the card runs the adjoints K5 and K6 (K12 and
K13 without the pdf); autograd differentiates the rest.

What the reference drops without a word, this module refuses
(NotImplementedError): directional and spot lights, directional-area
emitters and media (R16; SDFs and curves cannot enter a scene of the
port), a normal map (the reference shades with the geometric normal),
and a material with an opacity below 1 or the null kind (R18: the
reference gives a straight-through lane its lobe's Mueller matrix). In
spectral mode the RGB area and point emitters are upsampled by rgb2spec,
as in the scalar spectral path, not grayed by their channel mean (R17).
"""

from __future__ import annotations

import torch

from ..ops import mueller as mu
from ..ops import spectrum, warp
from ..ops.math import Frame, dot
from ..ops.rgb2spec import eval_emitter_coeff_spectrum
from . import bsdf as bsdf_mod
from . import emitters as em
from . import film as film_mod
from . import sensors as sensors_mod
from .bsdf import (CIRCULAR, CONDUCTOR, DIELECTRIC, NULL_BSDF, POLARIZER,
                   PPLASTIC, RETARDER, ROUGH_CONDUCTOR, fresnel_dielectric)
from .integrator import (_N_HERO, _SHADOW_EPS, _SamplerCtx, _check_slice,
                         _mis_weight, _offset, _pass_keys, _scene_hit,
                         _spp_chunk)
from .scene import (Scene, scene_occluded, table_len, with_emitter_coeffs,
                    with_mesh_tables)
from .texture import eval_texture, table_texture_kinds

def _axis(i, like):
    """The unit vector along axis i on `like`'s device, made there (a copy
    from the host would wait for the device)."""
    return torch.eye(3, device=like.device)[i]


def _fix_axis(a):
    """A unit s-axis, or [1, 0, 0] at the collinear singularity
    (|a|^2 < 1e-18; `tpusky/render/polarized.py:97-103`)."""
    n2 = (a * a).sum(-1, keepdim=True)
    return torch.where(n2 < 1e-18, _axis(0, a),
                       a / torch.sqrt(n2.clamp(min=1e-30)))


def _chan(x, nc):
    """(...,) -> (..., C), the value repeated over the channels."""
    return x[..., None].expand(*x.shape, nc)


def _specular_mueller_local(wi, wo, m_normal, eta_re, eta_im=None,
                            transmission=False):
    """Fresnel Mueller matrix of a specular event about micro-normal
    `m_normal`, rotated to the implicit bases of (-wo, wi) in the local
    frame (`conductor.cpp:281-300`, `roughconductor.cpp:282-301`,
    `dielectric.cpp:294-333`). Light arrives along -wo and leaves along
    wi; `eta_re`, `eta_im` (..., C) -> (..., C, 4, 4)."""
    cos_theta = (wo * m_normal).sum(-1)
    if transmission:
        f = mu.specular_transmission(cos_theta[..., None], eta_re)
    else:
        f = mu.specular_reflection(cos_theta[..., None], eta_re,
                                   0.0 if eta_im is None else eta_im)
    s_in = _fix_axis(torch.linalg.cross(m_normal, -wo, dim=-1))
    s_out = _fix_axis(torch.linalg.cross(m_normal, wi, dim=-1))
    return mu.rotate_mueller_basis(f, -wo, s_in, mu.stokes_basis(-wo),
                                   wi, s_out, mu.stokes_basis(wi))


def _filter_mueller_local(table, mat_idx, kind, wi, trans, present):
    """Mueller matrices of the straight-through filters (polarizer,
    retarder, circular) of the kinds in `present`, local frame: light
    propagates along wi (`polarizer.cpp:126-146`, `retarder.cpp:104-139`,
    `circular.cpp:90-111`). `trans` (N, C) the transmittance."""
    n, c = wi.shape[0], trans.shape[-1]
    extra = table.extra[mat_idx]
    theta = torch.deg2rad(extra[..., 0])
    forward = wi
    x_axis = _axis(0, wi).expand(wi.shape)
    out = torch.zeros((n, c, 4, 4), device=wi.device)
    if POLARIZER in present:
        # the tilted effective transmission axis (Korger et al. 2013,
        # `polarizer.cpp:131-141`)
        sin_t, cos_t = torch.sin(theta), torch.cos(theta)
        a_axis = torch.stack([sin_t, cos_t, torch.zeros_like(sin_t)], -1)
        eff_a = a_axis - (a_axis * forward).sum(-1, keepdim=True) * forward
        eff_a = eff_a / torch.linalg.vector_norm(
            eff_a, dim=-1, keepdim=True).clamp(min=1e-12)
        eff_t = torch.linalg.cross(forward, eff_a, dim=-1)
        m_pol = mu.linear_polarizer(torch.ones((n, c), device=wi.device))
        m_pol = mu.rotate_mueller_basis_collinear(
            m_pol, forward, eff_t, mu.stokes_basis(forward))
        out = torch.where((kind == POLARIZER)[:, None, None, None], m_pol,
                          out)
    if RETARDER in present:
        # a phase falling off with the cosine, the element's rotation
        # mirrored from the back (`retarder.cpp:106-120`)
        cos_i = wi[..., 2]
        delta = torch.deg2rad(extra[..., 1]) * cos_i.abs()
        m_ret = mu.linear_retarder(_chan(delta, c))
        m_ret = mu.rotated_element((torch.sign(cos_i) * theta)[..., None],
                                   m_ret)
        m_ret = mu.rotate_mueller_basis_collinear(
            m_ret, forward, x_axis, mu.stokes_basis(forward))
        out = torch.where((kind == RETARDER)[:, None, None, None], m_ret,
                          out)
    if CIRCULAR in present:
        left = extra[..., 2] > 0.5
        m_circ = torch.where(left[:, None, None, None],
                             mu.left_circular_polarizer(wi.device),
                             mu.right_circular_polarizer(wi.device))
        m_circ = mu.rotate_mueller_basis_collinear(
            m_circ.expand(n, c, 4, 4), forward, x_axis,
            mu.stokes_basis(forward))
        out = torch.where((kind == CIRCULAR)[:, None, None, None], m_circ,
                          out)
    return out * mu.absorber(trans)


def _polarize_scaled(m_fresnel, scalar):
    """M * (scalar / M[0, 0]): the exact polarized Fresnel ratios on the
    scalar radiometry (zero where M[0, 0] <= 1e-12)."""
    m00 = m_fresnel[..., 0:1, 0:1]
    scale = torch.where(m00 > 1e-12, scalar[..., None, None]
                        / m00.clamp(min=1e-12), 0.0)
    return m_fresnel * scale


def _conductor_eta_k(table, mat_idx, wavelengths):
    """A conductor's IOR a channel: RGB as it is; spectral, the mean of
    its three channels, as the scalar core's Fresnel term."""
    eta, k = table.eta[mat_idx], table.k[mat_idx]
    if wavelengths is None:
        return eta, k
    shape = eta.shape[:-1] + wavelengths.shape[-1:]
    return (eta.mean(-1, keepdim=True).expand(shape),
            k.mean(-1, keepdim=True).expand(shape))


def _pplastic_mueller_eval(table, mat_idx, wi, wo, refl_tex=None,
                           wavelengths=None):
    """Polarized plastic's Mueller eval (`pplastic.cpp:280-369`): the GGX
    coat's reflection about the half vector plus the depolarizing base
    between the two refractions, about the normal -> (N, C, 4, 4)."""
    cos_i = wi[..., 2].clamp(min=0.0)
    cos_o = wo[..., 2].clamp(min=0.0)
    alpha = table.alpha[mat_idx].clamp(min=1e-3)
    ior = table.ior[mat_idx]
    albedo = bsdf_mod._apply_tex(
        bsdf_mod._reflectance(table, mat_idx, wavelengths), refl_tex)
    c = albedo.shape[-1]

    h = bsdf_mod._unit(wi + wo)
    d_ndf = bsdf_mod._ggx_ndf(h, alpha)
    g = bsdf_mod._ggx_g1(wi, alpha) * bsdf_mod._ggx_g1(wo, alpha)
    spec_scalar = d_ndf * g / (4.0 * cos_i.clamp(min=1e-6))
    eta_c = _chan(ior, c)
    m_spec = (_specular_mueller_local(wi, wo, h, eta_c)
              * spec_scalar[..., None, None, None])

    # the base: refracted in at the light's side wo (t_o), depolarized,
    # refracted out at wi's internal direction (t_i, `pplastic.cpp:339-342`)
    t_o = mu.specular_transmission(wo[..., 2].abs()[..., None], eta_c)
    _, cos_t_i, _ = fresnel_dielectric(cos_i, ior)
    t_i = mu.specular_transmission(cos_t_i.abs()[..., None],
                                   _chan(1.0 / ior, c))
    diff = mu.matmul(t_i, mu.matmul(mu.depolarizer(albedo), t_o))
    n = _axis(2, wi).expand(wi.shape)
    diff = mu.rotate_mueller_basis(
        diff, -wo, _fix_axis(torch.linalg.cross(n, -wo, dim=-1)),
        mu.stokes_basis(-wo),
        wi, _fix_axis(torch.linalg.cross(n, wi, dim=-1)),
        mu.stokes_basis(wi))
    m_diff = diff * (warp.INV_PI * cos_o)[..., None, None, None]
    ok = (cos_i > 0.0) & (cos_o > 0.0)
    return torch.where(ok[..., None, None, None], m_spec + m_diff, 0.0)


def _pol_weight_eval(table, mat_idx, wi, wo, scalar_val, kinds,
                     refl_tex=None, wavelengths=None):
    """Mueller matrix of an evaluated direction pair (next-event
    estimation): polarized Fresnel for the rough conductor, pplastic's
    own eval, a depolarizer of the scalar value for every other kind.
    Local frame, (N, C, 4, 4)."""
    present = bsdf_mod.table_kinds(table)[0] if kinds is None else kinds[0]
    kind = table.kind[mat_idx]
    out = mu.depolarizer(scalar_val)
    if ROUGH_CONDUCTOR in present:
        m = bsdf_mod._unit(wi + wo)
        eta_c, k_c = _conductor_eta_k(table, mat_idx, wavelengths)
        f = _specular_mueller_local(wi, wo, m, eta_c, k_c)
        out = torch.where((kind == ROUGH_CONDUCTOR)[..., None, None, None],
                          _polarize_scaled(f, scalar_val), out)
    if PPLASTIC in present:
        out = torch.where((kind == PPLASTIC)[..., None, None, None],
                          _pplastic_mueller_eval(table, mat_idx, wi, wo,
                                                 refl_tex, wavelengths),
                          out)
    return out


def _pol_weight_sample(table, mat_idx, wi, wo, scalar_w, pdf, kinds,
                       refl_tex=None, wavelengths=None):
    """Mueller weight of a sampled direction: the delta lobes' Fresnel
    and filter matrices, the eval's matrix over the pdf for the rough
    conductor and pplastic, a depolarizer of the scalar weight for every
    other kind. Local frame, (N, C, 4, 4)."""
    present = bsdf_mod.table_kinds(table)[0] if kinds is None else kinds[0]
    kind = table.kind[mat_idx]
    nc = scalar_w.shape[-1]
    out = mu.depolarizer(scalar_w)
    if ROUGH_CONDUCTOR in present or PPLASTIC in present:
        m_ev = _pol_weight_eval(table, mat_idx, wi, wo,
                                scalar_w * pdf[..., None], kinds, refl_tex,
                                wavelengths)
        scale = torch.where(pdf > 1e-12, 1.0 / pdf.clamp(min=1e-12), 0.0)
        sel = (kind == ROUGH_CONDUCTOR) | (kind == PPLASTIC)
        out = torch.where(sel[..., None, None, None],
                          m_ev * scale[..., None, None, None], out)
    if CONDUCTOR in present:
        nrm = _axis(2, wi) * torch.sign(wi[..., 2:3])   # two-sided
        eta_c, k_c = _conductor_eta_k(table, mat_idx, wavelengths)
        f = _specular_mueller_local(wi, wo, nrm, eta_c, k_c)
        out = torch.where((kind == CONDUCTOR)[..., None, None, None],
                          _polarize_scaled(f, scalar_w), out)
    if DIELECTRIC in present:
        eta_c = _chan(table.ior[mat_idx], nc)
        nrm = _axis(2, wi).expand(wi.shape)
        refl = wi[..., 2] * wo[..., 2] > 0.0
        f = torch.where(refl[..., None, None, None],
                        _specular_mueller_local(wi, wo, nrm, eta_c),
                        _specular_mueller_local(wi, wo, nrm, eta_c,
                                                transmission=True))
        # the scalar weight carries 1 / pdf and the eta^2 compression; the
        # chosen matrix's M00 is the choice's probability
        out = torch.where((kind == DIELECTRIC)[..., None, None, None],
                          _polarize_scaled(f, scalar_w), out)
    filters = [k for k in (POLARIZER, RETARDER, CIRCULAR) if k in present]
    if filters:
        trans = bsdf_mod._apply_tex(
            bsdf_mod._reflectance(table, mat_idx, wavelengths), refl_tex)
        is_filter = torch.zeros_like(kind, dtype=torch.bool)
        for k in filters:
            is_filter = is_filter | (kind == k)
        out = torch.where(is_filter[..., None, None, None],
                          _filter_mueller_local(table, mat_idx, kind, wi,
                                                trans, filters), out)
    return out


def _check_stokes(scene: Scene, kinds):
    """Refuse what the reference's Stokes path drops or gets wrong."""
    dropped = [name for name, there in (
        ("directional lights", table_len(scene.directional_lights)),
        ("spot lights", len(scene.spot_lights)),
        ("directional-area emitters", scene.dir_area_radiance is not None),
        ("a medium", scene.medium is not None)) if there]
    if dropped:
        raise NotImplementedError(
            f"R16: render_stokes of a scene with {', '.join(dropped)} (the "
            "reference's Stokes path drops them without a word)")
    if scene.textures is not None and bsdf_mod.table_normal_maps(
            scene.bsdfs):
        raise NotImplementedError(
            "render_stokes of a normal-mapped material (the reference's "
            "Stokes path shades with the geometric normal)")
    present, any_mask = kinds
    if any_mask or NULL_BSDF in present:
        raise NotImplementedError(
            "R18: render_stokes of a material with an opacity below 1 or "
            "of the null kind (the reference gives a lane that passes "
            "straight through its lobe's Mueller matrix)")


def path_sample_polarized(scene: Scene, o, d, smp: _SamplerCtx,
                          max_depth: int, rr_depth: int = 1000, kinds=None,
                          wavelengths=None, plain: bool = False):
    """Stokes radiance along primary rays -> (N, C, 4), in the implicit
    bases `stokes_basis(-d)` of the primary directions (rotate with
    `sensor_stokes_rotation` for display, `stokes.cpp:100-110`). The
    sample dimensions are the reference's: 3 depth + 0 the environment's
    NEE, + 1 the BSDF, + 2 the roulette, 3 depth + 3 the area NEE."""
    kinds = bsdf_mod.table_kinds(scene.bsdfs) if kinds is None else kinds
    mode = "rgb" if wavelengths is None else "spectral"
    _check_stokes(scene, kinds)
    _check_slice(scene, max_depth, rr_depth, mode, kinds)
    if wavelengths is not None:
        scene = with_emitter_coeffs(scene)
    n, dev = o.shape[0], o.device
    nc = 3 if wavelengths is None else wavelengths.shape[-1]
    env, env_to_world = scene.env, scene.env_to_world
    n_area = table_len(scene.area_emitter_shapes)
    n_point = table_len(scene.point_lights)
    textured = scene.textures is not None
    tkinds = table_texture_kinds(scene.textures)
    bsdfs = scene.bsdfs

    throughput = torch.eye(4, device=dev).expand(n, nc, 4, 4)
    result = torch.zeros((n, nc, 4), device=dev)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    prev_pdf = torch.ones((n,), device=dev)
    prev_delta = torch.ones((n,), dtype=torch.bool, device=dev)

    def emitter_hits(result, active, o, d, throughput, prev_pdf,
                     prev_delta, geo):
        """The escaped lanes' sky and the area emitters' radiance at hits,
        each under MIS against the previous BSDF sample, through the
        throughput's first column (an unpolarized source)."""
        p, ng, shape_idx, hit = geo[1], geo[2], geo[3], geo[5]
        col = throughput[..., :, 0]
        if env is not None:
            env_l, em_pdf = em.env_eval_pdf(env, d, env_to_world,
                                            wavelengths, mode,
                                            pdf_detached=True, plain=plain)
            em_pdf = torch.where(prev_delta, 0.0, em_pdf)
            mis = _mis_weight(prev_pdf, em_pdf.detach())
            result = result + torch.where(
                (active & ~hit)[..., None, None],
                col * (env_l * mis[..., None])[..., None], 0.0)
        # emitting shapes as in the scalar path, also where none is
        # sampled by NEE (the reference's Stokes path reads them only
        # beside area emitters, `tpusky/render/polarized.py:421`)
        if scene.area_radiance is not None:
            rows = shape_idx.clamp(min=0)
            if wavelengths is None:
                area_l = scene.area_radiance[rows]
            elif n_area > 0:        # rgb2spec spectra, not gray (R17)
                area_l = eval_emitter_coeff_spectrum(
                    scene.emitter_coeffs.area[rows], wavelengths)
            else:
                area_l = scene.area_radiance[rows].mean(-1, keepdim=True)
            if n_area > 0:
                area_pdf = em.area_pdf_direction(scene, o, p, ng, rows)
                area_pdf = torch.where(prev_delta, 0.0, area_pdf)
                area_l = area_l * _mis_weight(
                    prev_pdf, area_pdf.detach())[..., None]
            facing = (dot(ng, -d) > 0.0) & (shape_idx >= 0)
            result = result + torch.where(
                (active & hit & facing)[..., None, None],
                col * area_l[..., None], 0.0)
        return result

    for depth in range(max_depth - 1):
        geo = _scene_hit(scene, o, d, plain, textured)
        p, ng, mat_idx, hit = geo[1], geo[2], geo[4], geo[5]
        result = emitter_hits(result, active, o, d, throughput, prev_pdf,
                              prev_delta, geo)
        active = active & hit
        refl_tex = None
        if textured:
            refl_tex = eval_texture(scene.textures, bsdfs.tex_idx[mat_idx],
                                    geo[6], wavelengths, p=p, attr=geo[7],
                                    tkinds=tkinds)
        frame = Frame(ng)
        wi_local = frame.to_local(-d)
        # the output side's rotation to the world basis, shared by every
        # strategy here: R_out of `to_world_mueller`
        wi_world = frame.to_world(wi_local)
        r_out = mu.rotate_stokes_basis(
            wi_world, frame.to_world(mu.stokes_basis(wi_local)),
            mu.stokes_basis(wi_world))
        thr_out = mu.matmul(throughput, r_out[:, None])

        def light(wo_local, scalar_val):
            """T @ M_world's first column toward wo_local: the Stokes
            weight of an unpolarized source there."""
            m_local = _pol_weight_eval(bsdfs, mat_idx, wi_local, wo_local,
                                       scalar_val, kinds, refl_tex,
                                       wavelengths)
            return mu.apply_stokes(thr_out, m_local[..., :, 0])

        # ---- next-event estimation toward the environment ----
        if env is not None:
            u_nee = smp.next(3 * depth + 0, 2).detach()
            d_e, l_e, pdf_e = em.env_sample_eval(
                env, env_to_world, u_nee, wavelengths, mode,
                pdf_detached=True, plain=plain)
            pdf_e = pdf_e.detach()
            wo_e = frame.to_local(d_e)
            f_val, pdf_b = bsdf_mod.eval_pdf(bsdfs, mat_idx, wi_local, wo_e,
                                             wavelengths, kinds=kinds,
                                             refl_tex=refl_tex)
            occ = scene_occluded(scene, _offset(p, ng, d_e), d_e, torch.inf,
                                 plain=plain)
            mis = _mis_weight(pdf_e, pdf_b.detach())
            w = l_e * (mis / pdf_e.clamp(min=1e-20))[..., None]
            ok = active & ~occ & (pdf_e > 0.0)
            result = result + torch.where(ok[..., None, None],
                                          light(wo_e, f_val) * w[..., None],
                                          0.0)

        # ---- next-event estimation toward the area emitters ----
        if n_area > 0:
            u_area = smp.next(3 * depth + 3, 3).detach()
            d_a, dist_a, pdf_a, l_a, _, emit_a = em.area_sample_direction(
                scene, p, u_area[..., :2], u_area[..., 2])
            d_a, pdf_a = d_a.detach(), pdf_a.detach()
            if wavelengths is not None:      # rgb2spec, not gray (R17)
                l_a = eval_emitter_coeff_spectrum(
                    scene.emitter_coeffs.area[emit_a], wavelengths)
            wo_a = frame.to_local(d_a)
            f_a, pdf_b_a = bsdf_mod.eval_pdf(bsdfs, mat_idx, wi_local, wo_a,
                                             wavelengths, kinds=kinds,
                                             refl_tex=refl_tex)
            # the shadow ray starts along itself (`integrator._path_sample`)
            eps_a = _SHADOW_EPS * torch.linalg.vector_norm(
                p, dim=-1).clamp(min=1.0)
            occ_a = scene_occluded(scene, p + eps_a[..., None] * d_a, d_a,
                                   (dist_a - eps_a) * (1.0 - 1e-3),
                                   plain=plain)
            mis_a = _mis_weight(pdf_a, pdf_b_a.detach())
            w = l_a * (mis_a / pdf_a.clamp(min=1e-20))[..., None]
            ok_a = active & ~occ_a & (pdf_a > 0.0)
            result = result + torch.where(ok_a[..., None, None],
                                          light(wo_a, f_a) * w[..., None],
                                          0.0)

        # ---- every point light (no pick: the reference sums them) ----
        for li in range(n_point):
            row = scene.point_lights[li]
            to_l = row[:3] - p
            dist2 = (to_l * to_l).sum(-1)
            dist = torch.sqrt(dist2.clamp(min=1e-12))
            d_l = to_l / dist[..., None]
            wo_l = frame.to_local(d_l)
            f_l, _ = bsdf_mod.eval_pdf(bsdfs, mat_idx, wi_local, wo_l,
                                       wavelengths, kinds=kinds,
                                       refl_tex=refl_tex)
            occ_l = scene_occluded(scene, _offset(p, ng, d_l), d_l,
                                   dist * (1 - 1e-3), plain=plain)
            inten = (row[3:] if wavelengths is None else
                     eval_emitter_coeff_spectrum(
                         scene.emitter_coeffs.point[li], wavelengths))
            w = inten / dist2[..., None]
            result = result + torch.where(
                (active & ~occ_l)[..., None, None],
                light(wo_l, f_l) * w[..., None], 0.0)

        # ---- BSDF sampling for the next bounce ----
        u_bsdf = smp.next(3 * depth + 1, 3).detach()
        wo_local, weight, pdf_b, is_delta = bsdf_mod.sample(
            bsdfs, mat_idx, wi_local, u_bsdf[..., :2], u_bsdf[..., 2],
            wavelengths, kinds=kinds, refl_tex=refl_tex)
        wo_local = wo_local.detach()
        m_local = _pol_weight_sample(bsdfs, mat_idx, wi_local, wo_local,
                                     weight, pdf_b, kinds, refl_tex,
                                     wavelengths)
        in_world = frame.to_world(-wo_local)
        r_in = mu.rotate_stokes_basis(
            in_world, frame.to_world(mu.stokes_basis(-wo_local)),
            mu.stokes_basis(in_world))
        thr_next = mu.matmul(mu.matmul(thr_out, m_local),
                             r_in.transpose(-1, -2)[:, None])
        d_next = frame.to_world(wo_local)
        active = active & (pdf_b > 0.0)
        if depth + 1 >= rr_depth:
            # Russian roulette on the unpolarized throughput
            rr_prob = thr_next[..., 0, 0].detach().amax(-1).clamp(0.0, 0.95)
            u_rr = smp.next(3 * depth + 2, 1)[..., 0].detach()
            thr_next = thr_next / rr_prob.clamp(min=1e-6)[:, None, None,
                                                          None]
            active = active & (u_rr < rr_prob)
        keep = active[..., None]
        o = torch.where(keep, _offset(p, ng, d_next), o)
        d = torch.where(keep, d_next, d)
        throughput = torch.where(keep[..., None, None], thr_next,
                                 throughput)
        prev_pdf = torch.where(active, pdf_b.detach(), prev_pdf)
        prev_delta = torch.where(active, is_delta, prev_delta)

    # the last vertex: emitter hits only
    geo = _scene_hit(scene, o, d, plain)
    return emitter_hits(result, active, o, d, throughput, prev_pdf,
                        prev_delta, geo)


def sensor_stokes_rotation(sensor, d):
    """Rotator from the primary rays' implicit bases stokes_basis(-d) to
    the sensor's horizontal, cross(d, sensor vertical)
    (`stokes.cpp:100-110`); where d is along the vertical the implicit
    basis stays. -> (N, 4, 4)."""
    to_world = getattr(sensor, "to_world", None)
    vertical = _axis(2, d) if to_world is None else to_world[:3, 1]
    current = mu.stokes_basis(-d)
    target = torch.linalg.cross(d, vertical.expand(d.shape), dim=-1)
    n2 = (target * target).sum(-1, keepdim=True)
    target = torch.where(n2 < 1e-12, current, target)
    return mu.rotate_stokes_basis(-d, current, target)


def stokes_lanes(scene: Scene, sensor, film_cfg, seed, spp, spp0,
                 spp_chunk, max_depth, rr_depth, mode="rgb",
                 sampler_kind="independent", kinds=None, plain=False,
                 row0=0, n_rows=None, col0=0, n_cols=None):
    """Per-lane Stokes vectors (n_rows * n_cols * spp_chunk, 3, 4) of
    `spp_chunk` of the `spp` samples for a block of the film (all of it by
    default), lanes pixel-ordered: sRGB channels by S0..S3, aligned with
    the sensor's horizontal, non-finite values zeroed
    (`tpusky/render/polarized.py:619-651`). `seed` as `render_rows`'."""
    h, w = film_cfg.height, film_cfg.width
    n_rows = h if n_rows is None else n_rows
    n_cols = w if n_cols is None else n_cols
    dev = scene.shapes.to_world.device
    n = n_rows * n_cols * spp_chunk
    lane = torch.arange(n, dtype=torch.int64, device=dev)
    block = lane // spp_chunk
    pixel = (row0 + block // n_cols) * w + col0 + block % n_cols
    smp = _SamplerCtx(sampler_kind, seed, pixel, spp0 + lane % spp_chunk,
                      spp)
    u_pos = smp.next(10_000, 2)
    uv = torch.stack([((pixel % w).float() + u_pos[:, 0]) / w,
                      ((pixel // w).float() + u_pos[:, 1]) / h], -1)
    o, d = sensors_mod.sample_ray(sensor, uv)
    if mode == "spectral":
        # hero-wavelength polarized transport (the *_spectral_polarized
        # variants), each Stokes component developed to sRGB with the
        # shared weight (`stokes.cpp:117-128`)
        u_wl = smp.next(20_000, 1)[..., 0]
        wavelengths, wl_weight = spectrum.sample_rgb_spectrum(
            spectrum.sample_shifted(u_wl, _N_HERO))
        spec = path_sample_polarized(scene, o, d, smp, max_depth, rr_depth,
                                     kinds, wavelengths, plain)
        stokes = torch.stack([spectrum.spectrum_to_srgb(
            spec[..., si] * wl_weight, wavelengths) for si in range(4)], -1)
    else:
        stokes = path_sample_polarized(scene, o, d, smp, max_depth, rr_depth,
                                       kinds, None, plain)
    stokes = mu.apply_stokes(sensor_stokes_rotation(sensor, d)[:, None],
                             stokes)
    return torch.where(torch.isfinite(stokes), stokes, 0.0)


def render_stokes(scene: Scene, sensor, film: film_mod.Film, key,
                  spp: int = 16, max_depth: int = 4, rr_depth: int = 1000,
                  sampler_kind: str = "independent", mode: str = "rgb",
                  max_lanes: int = 1 << 20, plain: bool = False):
    """Render the full polarization state -> (H, W, 4, 3): S0 (radiance)
    and S1..S3 aligned with the sensor's horizontal, the reference
    `stokes` integrator's output (`stokes.cpp:113-131`), box-filtered over
    the whole film as the reference's. `mode="spectral"` runs
    4-hero-wavelength polarized transport. `key` as `integrator.render`'s
    (one pass). The live wavefront is bounded to `max_lanes` lanes by spp
    chunks, as `render_rows` bounds it; K14's tables are built and, in
    spectral mode, the RGB emitters fitted once a call. `plain=True` runs
    the plain versions of K2/K3/K10/K11/K14 on any device."""
    kinds = bsdf_mod.table_kinds(scene.bsdfs)
    seed = _pass_keys(key, 1)[0]
    scene = with_mesh_tables(scene, plain)
    if mode == "spectral":
        scene = with_emitter_coeffs(scene)
    h, w = film.height, film.width
    cfg = film_mod.Film(h, w, 12)
    chunk = _spp_chunk(cfg, spp, h, max_lanes)
    accum = None
    for spp0 in range(0, spp, chunk):
        lanes = stokes_lanes(scene, sensor, cfg, seed, spp, spp0, chunk,
                             max_depth, rr_depth, mode, sampler_kind, kinds,
                             plain)
        # the 4 components as a 12-channel image
        a = film_mod.splat_ordered(cfg, lanes.transpose(-1, -2).reshape(
            -1, 12), chunk)
        accum = a if accum is None else accum + a
    return film_mod.develop(accum).reshape(h, w, 4, 3)
