"""Mueller/Stokes polarization algebra (`tpusky/ops/mueller.py`).

The counterpart of the reference's Mueller-matrix library
(`include/mitsuba/render/mueller.h`) and its polarized Fresnel equations
(`fresnel.h:227` `fresnel_polarized`), as plain tensor code on any
device, differentiable by autograd.

Conventions (the reference's, `mueller.h:10-27`):
  * Light's polarization state is a Stokes vector, seen from the sensor
    side looking back against the propagation direction.
  * A Stokes vector means something only with a reference basis
    orthogonal to the propagation direction. Bases are never stored:
    `stokes_basis(d)` derives the implicit basis of direction `d` (the
    first tangent of the Duff frame, `mueller.h:284-287`).
  * Mueller matrices are (..., C, 4, 4), C the spectral channels; Stokes
    vectors (..., C, 4). A rotation, which depends on geometry alone,
    broadcasts over C through a singleton axis.

Every constructor broadcasts its arguments and appends (4, 4). The
layout decides the card's time at a million lanes: a matrix is built by
stacking its 16 entries as planes and transposing them once (a stack
along the last axis writes 4 bytes in every 64 and ran ~10x slower), and
a product is a broadcast multiply and a sum over k in float32 (a batched
`torch.matmul` of 4x4 matrices ran ~10x slower through cuBLAS's small
GEMMs, and TF32 would round the products to a 10-bit mantissa, as the
reference's bf16 MXU passes would, `tpusky/ops/mueller.py:42-50`).
Complex numbers are explicit (re, im) float32 pairs, as in the
reference.
"""

from __future__ import annotations

import torch

from .math import coordinate_system, safe_asin


def _f32(x, like=None):
    """x as a float32 tensor; a Python number is filled on `like`'s device
    (a fill, not a copy from the host, which would wait for the device)."""
    if isinstance(x, torch.Tensor):
        return x.float() if x.dtype != torch.float32 else x
    dev = like.device if like is not None else None
    return torch.full((), x, dtype=torch.float32, device=dev)


def _mm(rows):
    """A (..., 4, 4) matrix from 16 broadcastable entries (rows of 4): the
    entries stacked as leading planes, then moved behind the batch dims
    in one copy."""
    flat = [e for r in rows for e in r]
    like = next((e for e in flat if isinstance(e, torch.Tensor)), None)
    flat = [_f32(e, like) for e in flat]
    shape = torch.broadcast_shapes(*[e.shape for e in flat])
    planes = torch.stack([e.expand(shape) for e in flat], 0)
    return planes.movedim(0, -1).reshape(*shape, 4, 4)


def matmul(a, b):
    """Mueller matrix product, batched (and broadcast) over the leading
    dims, channels included: sum_k a[..., i, k] b[..., k, j]."""
    return (a.unsqueeze(-1) * b.unsqueeze(-3)).sum(-2)


def apply_stokes(m, s):
    """A (..., 4, 4) Mueller matrix applied to a (..., 4) Stokes vector."""
    return (m * s.unsqueeze(-2)).sum(-1)


def depolarizer(value=1.0):
    """Ideal depolarizer: only the (0, 0) entry (`mueller.h:37-41`)."""
    v = _f32(value)
    z = torch.zeros_like(v)
    return _mm([[v, z, z, z], [z, z, z, z], [z, z, z, z], [z, z, z, z]])


def absorber(value):
    """Neutral attenuation `value * I` (`mueller.h:50-52`), as a scale
    factor with two singleton dims to multiply a matrix by."""
    return _f32(value)[..., None, None]


def linear_polarizer(value=1.0):
    """Linear polarizer transmitting at 0 degrees; Collett Ch.5 eq. (13)
    (`mueller.h:65-73`)."""
    a = _f32(value) * 0.5
    z = torch.zeros_like(a)
    return _mm([[a, a, z, z], [a, a, z, z], [z, z, z, z], [z, z, z, z]])


def linear_retarder(phase):
    """Linear retarder, fast axis horizontal; Goldstein eq. (6.43)
    (`mueller.h:91-100`)."""
    phase = _f32(phase)
    s, c = torch.sin(phase), torch.cos(phase)
    o, z = torch.ones_like(s), torch.zeros_like(s)
    return _mm([[o, z, z, z], [z, o, z, z], [z, z, c, s], [z, z, -s, c]])


def _circular_polarizer(sign, device):
    h = torch.full((), 0.5, device=device)
    z = torch.zeros((), device=device)
    return _mm([[h, z, z, sign * h], [z, z, z, z], [z, z, z, z],
                [sign * h, z, z, h]])


def right_circular_polarizer(device="cuda"):
    """Chipman et al., Table 6.2 (`mueller.h:108-115`); on the card unless
    `device` names another."""
    return _circular_polarizer(1.0, device)


def left_circular_polarizer(device="cuda"):
    """Chipman et al., Table 6.2 (`mueller.h:123-130`); on the card unless
    `device` names another."""
    return _circular_polarizer(-1.0, device)


def diattenuator(x, y):
    """Attenuate the field components at 0/90 degrees by x/y
    (`mueller.h:138-149`)."""
    x, y = _f32(x), _f32(y)
    a = 0.5 * (x + y)
    b = 0.5 * (x - y)
    c = torch.sqrt((x * y).clamp(min=0.0))
    z = torch.zeros_like(a)
    return _mm([[a, b, z, z], [b, a, z, z], [z, z, c, z], [z, z, z, c]])


def rotator(theta):
    """Rotate the Stokes reference frame counter-clockwise (sensor view)
    by `theta`; Collett Ch.5 eq. (43) (`mueller.h:164-172`)."""
    theta = _f32(theta)
    s, c = torch.sin(2.0 * theta), torch.cos(2.0 * theta)
    o, z = torch.ones_like(s), torch.zeros_like(s)
    return _mm([[o, z, z, z], [z, c, s, z], [z, -s, c, z], [z, z, z, o]])


def rotated_element(theta, m):
    """An element rotated counter-clockwise: R(theta)^T M R(theta)
    (`mueller.h:179-183`)."""
    r = rotator(theta)
    return matmul(r.transpose(-1, -2), matmul(m, r))


# ---------------------------------------------------------------------------
# Polarized Fresnel (fresnel.h:227, complex form, which holds the real one)
# ---------------------------------------------------------------------------


def _cmul(a, b):
    return a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0]


def _crcp(a):
    d = (a[0] * a[0] + a[1] * a[1]).clamp(min=1e-30)
    return a[0] / d, -a[1] / d


def _cdiv(a, b):
    return _cmul(a, _crcp(b))


def _cabs2(a):
    return a[0] * a[0] + a[1] * a[1]


def _csqrt(a):
    """Principal complex square root (re >= 0) of an (re, im) pair."""
    r = torch.sqrt(_cabs2(a).clamp(min=0.0))
    re = torch.sqrt((0.5 * (r + a[0])).clamp(min=0.0))
    im_mag = torch.sqrt((0.5 * (r - a[0])).clamp(min=0.0))
    return re, torch.where(a[1] < 0.0, -im_mag, im_mag)


def fresnel_polarized(cos_theta_i, eta_re, eta_im=0.0):
    """Complex s/p reflection amplitudes at a dielectric or conducting
    interface (`fresnel.h:227-289`), kappa's sign normalised to the
    physics convention (`fresnel.h:231-234`) -> ((a_s_re, a_s_im),
    (a_p_re, a_p_im), cos_theta_t, eta_it_real, eta_ti_real)."""
    cos_theta_i = _f32(cos_theta_i)
    eta_re = _f32(eta_re, cos_theta_i)
    eta_im = _f32(eta_im, cos_theta_i)
    eta_im = eta_im.expand(torch.broadcast_shapes(eta_re.shape,
                                                  eta_im.shape))
    eta = (eta_re, -eta_im.abs())

    outside = cos_theta_i >= 0.0
    rcp_eta = _crcp(eta)
    eta_it = (torch.where(outside, eta[0], rcp_eta[0]),
              torch.where(outside, eta[1], rcp_eta[1]))
    eta_ti = (torch.where(outside, rcp_eta[0], eta[0]),
              torch.where(outside, rcp_eta[1], eta[1]))

    sin2 = 1.0 - cos_theta_i ** 2
    ti2 = _cmul(eta_ti, eta_ti)
    ct_sqr = (1.0 - sin2 * ti2[0], -sin2 * ti2[1])
    cos_i_abs = cos_theta_i.abs()
    ct = _csqrt(ct_sqr)
    # the component-wise sign fix (drjit's `mulsign` with cos_theta_t^2)
    # picks the physical root under total internal reflection (Clarke,
    # "Stellar Polarimetry" A.2)
    ct = (ct[0] * torch.where(ct_sqr[0] < 0.0, -1.0, 1.0),
          ct[1] * torch.where(ct_sqr[1] < 0.0, -1.0, 1.0))

    it_ct = _cmul(eta_it, ct)
    a_s = _cdiv((cos_i_abs - it_ct[0], -it_ct[1]),
                (cos_i_abs + it_ct[0], it_ct[1]))
    it_ci = (eta_it[0] * cos_i_abs, eta_it[1] * cos_i_abs)
    a_p = _cdiv((it_ci[0] - ct[0], it_ci[1] - ct[1]),
                (it_ci[0] + ct[0], it_ci[1] + ct[1]))

    degenerate = ((eta[0] == 1.0) | (eta[0] == 0.0)) & (eta[1] == 0.0)
    a_s = (torch.where(degenerate, 0.0, a_s[0]),
           torch.where(degenerate, 0.0, a_s[1]))
    a_p = (torch.where(degenerate, 0.0, a_p[0]),
           torch.where(degenerate, 0.0, a_p[1]))

    # the transmitted cosine (0 under TIR), of the opposite sign to cos_i
    cos_t_signed = torch.where(ct_sqr[0] >= 0.0,
                               -ct[0].abs() * torch.sign(cos_theta_i), 0.0)
    return a_s, a_p, cos_t_signed, eta_it[0], eta_ti[0]


def _sincos_arg_diff(a_p, a_s):
    """(sin, cos) of the phase delay arg(a_p) - arg(a_s)."""
    z = _cmul(a_p, (a_s[0], -a_s[1]))
    r = torch.sqrt(_cabs2(z).clamp(min=0.0))
    safe = r.clamp(min=1e-20)
    return z[1] / safe, z[0] / safe


def specular_reflection(cos_theta_i, eta_re, eta_im=0.0):
    """Mueller matrix of specular reflection off a dielectric or conductor
    (`mueller.h:198-223`)."""
    a_s, a_p, _, _, _ = fresnel_polarized(cos_theta_i, eta_re, eta_im)
    sin_d, cos_d = _sincos_arg_diff(a_p, a_s)
    r_s, r_p = _cabs2(a_s), _cabs2(a_p)
    a = 0.5 * (r_s + r_p)
    b = 0.5 * (r_s - r_p)
    c = torch.sqrt((r_s * r_p).clamp(min=0.0))
    sin_d = torch.where(c == 0.0, 0.0, sin_d)
    cos_d = torch.where(c == 0.0, 0.0, cos_d)
    z = torch.zeros_like(a)
    return _mm([[a, b, z, z], [b, a, z, z],
                [z, z, c * cos_d, -c * sin_d], [z, z, c * sin_d, c * cos_d]])


def specular_transmission(cos_theta_i, eta):
    """Mueller matrix of specular transmission through a dielectric
    (`mueller.h:238-265`); `eta` real (> 0)."""
    cos_theta_i = _f32(cos_theta_i)
    a_s, a_p, cos_theta_t, eta_it, eta_ti = fresnel_polarized(cos_theta_i,
                                                              eta)
    # the power conversion between the media
    big = cos_theta_i.abs() > 1e-8
    factor = -eta_it * torch.where(
        big, cos_theta_t / torch.where(big, cos_theta_i, 1.0), 0.0)
    a_s_r = 1.0 + a_s[0]
    a_p_r = (1.0 + a_p[0]) * eta_ti
    t_s, t_p = a_s_r ** 2, a_p_r ** 2
    a = 0.5 * factor * (t_s + t_p)
    b = 0.5 * factor * (t_s - t_p)
    c = factor * torch.sqrt((t_s * t_p).clamp(min=0.0))
    z = torch.zeros_like(a)
    return _mm([[a, b, z, z], [b, a, z, z], [z, z, c, z], [z, z, z, c]])


# ---------------------------------------------------------------------------
# Reference-frame rotations
# ---------------------------------------------------------------------------


def stokes_basis(forward):
    """The implicit Stokes basis of propagation direction `forward`
    (`mueller.h:285-287`): the first tangent of the Duff frame."""
    return coordinate_system(forward)[0]


def _unit_angle(u, v):
    """The angle between unit vectors as 2 asin(|v - u| / 2) (mitsuba's
    `math::unit_angle`, without its mirror past 90 degrees, as the
    reference's)."""
    return 2.0 * safe_asin(0.5 * torch.linalg.vector_norm(v - u, dim=-1))


def _unitize(v):
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True).clamp(
        min=1e-20)


def rotate_stokes_basis(forward, basis_current, basis_target):
    """Rotator taking a Stokes vector from one basis to another of the same
    beam (`mueller.h:315-323`) -> (..., 4, 4)."""
    bc, bt = _unitize(basis_current), _unitize(basis_target)
    theta = _unit_angle(bc, bt)
    flip = (forward * torch.linalg.cross(bc, bt, dim=-1)).sum(-1) < 0.0
    return rotator(torch.where(flip, -theta, theta))


def rotate_mueller_basis(m, in_forward, in_basis_current, in_basis_target,
                         out_forward, out_basis_current, out_basis_target,
                         chan_axis=True):
    """M re-expressed for new input and output Stokes bases
    (`mueller.h:361-371`): R_out @ M @ R_in^T. With `chan_axis` the
    rotators take a singleton channel axis to broadcast against
    (..., C, 4, 4)."""
    r_in = rotate_stokes_basis(in_forward, in_basis_current,
                               in_basis_target)
    r_out = rotate_stokes_basis(out_forward, out_basis_current,
                                out_basis_target)
    if chan_axis:
        r_in, r_out = r_in[..., None, :, :], r_out[..., None, :, :]
    return matmul(r_out, matmul(m, r_in.transpose(-1, -2)))


def rotate_mueller_basis_collinear(m, forward, basis_current, basis_target,
                                   chan_axis=True):
    """The same rotation on both sides (`mueller.h:400-406`): R M R^T."""
    r = rotate_stokes_basis(forward, basis_current, basis_target)
    if chan_axis:
        r = r[..., None, :, :]
    return matmul(r, matmul(m, r.transpose(-1, -2)))


def to_world_mueller(frame, m_local, in_forward_local, out_forward_local):
    """A Mueller matrix between the local frame's implicit bases carried
    to the world frame's (`interaction.h:407-428`,
    `SurfaceInteraction::to_world_mueller`). `frame` is an `ops.math.Frame`
    over (..., 3) normals; `m_local` (..., C, 4, 4)."""
    in_fwd_w = frame.to_world(in_forward_local)
    out_fwd_w = frame.to_world(out_forward_local)
    return rotate_mueller_basis(
        m_local,
        in_fwd_w, frame.to_world(stokes_basis(in_forward_local)),
        stokes_basis(in_fwd_w),
        out_fwd_w, frame.to_world(stokes_basis(out_forward_local)),
        stokes_basis(out_fwd_w))
