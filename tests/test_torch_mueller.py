"""The port's Mueller algebra (`tpusky_torch/ops/mueller.py`) against the
JAX package's (`tpusky/ops/mueller.py`) on the CPU: every function, on
4,096 lanes from a numpy seed, each matrix within 1e-5 of its largest
entry.

Two tests decide a branch against a value that float32 rounding can move
from one side to the other: the sign of forward . (b_current x b_target)
in `rotate_stokes_basis` (near-parallel and antiparallel bases), and the
signs of cos_theta_t^2 under total internal reflection in
`fresnel_polarized`. Such lanes are counted on both sides, capped, and
left out of the bar; every other lane holds it. So are the few gold
lanes where the reference's own float32 amplitudes stray more than half
the bar from the formula in complex128, or where the port's does (the
complex square root takes the imaginary part from sqrt((|z| - Re z) / 2),
which cancels where cos_theta_t^2 is nearly real, as it is for a metal:
5.7% of the gold lanes, capped at 10%); the port's largest error against
complex128 is held within 1.5 times the reference's own.

At most 3 items, so that pytest-xdist's `--dist loadfile` hands this
file out after tests/test_multihost.py.
"""

import jax.numpy as jnp
import numpy as np
import torch

from tpusky.ops import mueller as JMU
from tpusky.ops.math import Frame as JFrame

from tpusky_torch.ops import mueller as TMU
from tpusky_torch.ops.math import Frame as TFrame

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)

N = 4096
BAR = 1e-5
FLIP_CAP = 0.01
STRAY_CAP = 0.1


def _err(port, ref):
    """Each lane's largest error over its (..., 4, 4) or (..., 4) entries,
    relative to the lane's largest entry (floor 1e-6)."""
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    err = np.abs(port - ref).reshape(port.shape[0], -1).max(-1)
    scale = np.abs(ref).reshape(ref.shape[0], -1).max(-1)
    return err / np.maximum(scale, 1e-6)


def _check(port, ref, what, skip=None):
    err = _err(port.numpy() if isinstance(port, torch.Tensor) else port, ref)
    if skip is not None:
        err = err[~skip]
    assert err.max() <= BAR, (what, float(err.max()))


def _units(rng, n=N):
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def test_elements_match_jax():
    """The depolarizer, absorber, linear polarizer, linear retarder, both
    circular polarizers, diattenuator, rotator and rotated element, and
    matmul and apply_stokes on random matrices and Stokes vectors."""
    rng = np.random.default_rng(0)
    v = rng.uniform(0.0, 2.0, (N, 3)).astype(np.float32)
    phase = rng.uniform(-np.pi, np.pi, (N, 3)).astype(np.float32)
    theta = rng.uniform(-np.pi, np.pi, (N,)).astype(np.float32)
    x, y = (rng.uniform(0.0, 1.0, (N, 3)).astype(np.float32)
            for _ in range(2))
    m = rng.normal(size=(N, 3, 4, 4)).astype(np.float32)
    s = rng.normal(size=(N, 3, 4)).astype(np.float32)
    t = {k: torch.tensor(a) for k, a in
         dict(v=v, phase=phase, theta=theta, x=x, y=y, m=m, s=s).items()}
    pairs = [
        ("depolarizer", TMU.depolarizer(t["v"]), JMU.depolarizer(v)),
        ("absorber", TMU.absorber(t["v"]) * t["m"], JMU.absorber(v) * m),
        ("linear_polarizer", TMU.linear_polarizer(t["v"]),
         JMU.linear_polarizer(v)),
        ("linear_retarder", TMU.linear_retarder(t["phase"]),
         JMU.linear_retarder(phase)),
        ("diattenuator", TMU.diattenuator(t["x"], t["y"]),
         JMU.diattenuator(x, y)),
        ("rotator", TMU.rotator(t["theta"]), JMU.rotator(theta)),
        ("rotated_element", TMU.rotated_element(t["theta"][:, None],
                                                t["m"]),
         JMU.rotated_element(theta[:, None], m)),
        ("matmul", TMU.matmul(t["m"], t["m"].flip(0)),
         JMU.matmul(m, m[::-1])),
        ("apply_stokes", TMU.apply_stokes(t["m"], t["s"]),
         JMU.apply_stokes(m, s)),
    ]
    for what, a, b in pairs:
        assert tuple(a.shape) == np.shape(b), what
        _check(a, b, what)
    for what, a, b in (("right", TMU.right_circular_polarizer("cpu"),
                        JMU.right_circular_polarizer()),
                       ("left", TMU.left_circular_polarizer("cpu"),
                        JMU.left_circular_polarizer())):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), what)
    # the default arguments
    np.testing.assert_array_equal(TMU.linear_polarizer().numpy(),
                                  np.asarray(JMU.linear_polarizer()))
    np.testing.assert_array_equal(TMU.depolarizer().numpy(),
                                  np.asarray(JMU.depolarizer()))


def _amplitudes_f64(cos, eta, k):
    """The reference's s and p amplitudes in complex128 (`fresnel.h:227`,
    `tpusky/ops/mueller.py::fresnel_polarized`)."""
    cos = cos.astype(np.float64)
    e = eta.astype(np.float64) - 1j * np.abs(k.astype(np.float64))
    e_it = np.where(cos >= 0.0, e, 1.0 / e)
    e_ti = np.where(cos >= 0.0, 1.0 / e, e)
    ct2 = 1.0 - (1.0 - cos ** 2) * e_ti ** 2
    ct = np.sqrt(ct2)
    ct = (ct.real * np.where(ct2.real < 0, -1, 1)
          + 1j * ct.imag * np.where(ct2.imag < 0, -1, 1))
    c = np.abs(cos)
    return ((c - e_it * ct) / (c + e_it * ct),
            (e_it * c - ct) / (e_it * c + ct))


def test_fresnel_polarized_matches_jax():
    """`fresnel_polarized`, `specular_reflection` and
    `specular_transmission` on a dielectric (entering and leaving, with
    total internal reflection) and on gold (complex IOR), at cosines
    across [-1, 1] with the exact ends and 0, and at the degenerate
    eta = 1. The TIR lanes whose sign tests flip between the two are
    counted and capped."""
    rng = np.random.default_rng(1)
    cos = rng.uniform(-1.0, 1.0, N).astype(np.float32)
    cos[:6] = [1.0, -1.0, 0.0, 1e-7, -1e-7, 0.5]
    cases = {
        "dielectric": (rng.uniform(1.1, 2.4, N).astype(np.float32), None),
        "gold": (np.tile(np.float32([0.143, 0.375, 1.442]), N // 3 + 1)[:N],
                 np.tile(np.float32([3.983, 2.386, 1.603]), N // 3 + 1)[:N]),
        "eta one": (np.ones(N, np.float32), None),
    }
    tir = np.zeros(N, bool)
    for name, (eta, k) in cases.items():
        args_j = (cos, eta) if k is None else (cos, eta, k)
        args_t = tuple(torch.tensor(a) for a in args_j)
        f_j = JMU.fresnel_polarized(*args_j)
        f_t = TMU.fresnel_polarized(*args_t)
        if k is None:
            # a lane under TIR whose cos_theta_t^2 sign tests disagree
            sin2 = 1.0 - cos.astype(np.float64) ** 2
            eta_ti = np.where(cos >= 0, 1.0 / eta, eta)
            ct2 = 1.0 - sin2 * eta_ti ** 2
            tir = np.abs(ct2) < 1e-6
        skip = tir
        if k is not None:
            # the reference's float32 amplitudes against complex128: where
            # they stray, the port is held to twice that error
            for amp_j, amp_t, amp64 in zip(f_j[:2], f_t[:2],
                                           _amplitudes_f64(cos, eta, k)):
                for part_j, part_t, part64 in ((amp_j[0], amp_t[0],
                                                amp64.real),
                                               (amp_j[1], amp_t[1],
                                                amp64.imag)):
                    scale = np.abs(amp64).clip(1e-6)
                    e_j = np.abs(np.asarray(part_j) - part64) / scale
                    e_t = np.abs(part_t.numpy() - part64) / scale
                    # as accurate as the reference
                    assert e_t.max() <= 1.5 * e_j.max(), (name, e_t.max(),
                                                          e_j.max())
                    skip = skip | (e_j > 0.5 * BAR) | (e_t > 0.5 * BAR)
            assert skip.mean() <= STRAY_CAP, (name, skip.mean())
        flat_t = [f_t[0][0], f_t[0][1], f_t[1][0], f_t[1][1], *f_t[2:]]
        flat_j = [f_j[0][0], f_j[0][1], f_j[1][0], f_j[1][1], *f_j[2:]]
        for i, (a, b) in enumerate(zip(flat_t, flat_j)):
            _check(a.numpy()[:, None], np.asarray(b)[:, None],
                   f"{name} fresnel output {i}", skip)
        _check(TMU.specular_reflection(*args_t),
               JMU.specular_reflection(*args_j), f"{name} reflection", skip)
        if k is None:
            _check(TMU.specular_transmission(*args_t),
                   JMU.specular_transmission(*args_j),
                   f"{name} transmission", tir)
    assert tir.mean() <= FLIP_CAP, tir.mean()
    # energy: reflection + transmission M00 = 1 off TIR (dielectric)
    eta = torch.full((N,), 1.5)
    c = torch.tensor(np.abs(cos) + 1e-3).clamp(max=1.0)
    r = TMU.specular_reflection(c, eta)[:, 0, 0]
    tr = TMU.specular_transmission(c, eta)[:, 0, 0]
    assert (r + tr - 1.0).abs().max() <= 1e-5


def test_basis_rotations_match_jax():
    """`stokes_basis`, `rotate_stokes_basis` (random bases about random
    beams, and bases within 1e-4 rad of parallel or antiparallel),
    `rotate_mueller_basis`, its collinear form and `to_world_mueller`.
    Lanes whose flip test forward . (b_c x b_t) < 0 differs between the
    two are counted (near-(anti)parallel bases: the cross product is
    rounding noise there) and capped at 1%."""
    rng = np.random.default_rng(2)
    fwd = _units(rng)
    b0 = np.asarray(JMU.stokes_basis(fwd))
    _check(TMU.stokes_basis(torch.tensor(fwd)), b0, "stokes_basis")
    # targets: b0 turned about fwd by a random angle, the last eighth by
    # less than 1e-4 rad off 0 or pi
    ang = rng.uniform(-np.pi, np.pi, N)
    ang[-N // 8:] = (rng.uniform(-1e-4, 1e-4, N // 8)
                     + np.pi * (np.arange(N // 8) % 2))
    t0 = np.cross(fwd, b0)
    bt = (np.cos(ang)[:, None] * b0 + np.sin(ang)[:, None] * t0).astype(
        np.float32)
    fwd_t, b0_t, bt_t = (torch.tensor(a) for a in (fwd, b0, bt))

    def flip_j(f, c, t):
        c = c / np.linalg.norm(c, axis=-1, keepdims=True)
        t = t / np.linalg.norm(t, axis=-1, keepdims=True)
        return np.asarray(jnp.sum(f * jnp.cross(c, t), -1) < 0)

    def flip_t(f, c, t):
        c = c / torch.linalg.vector_norm(c, dim=-1, keepdim=True)
        t = t / torch.linalg.vector_norm(t, dim=-1, keepdim=True)
        return ((f * torch.linalg.cross(c, t, dim=-1)).sum(-1) < 0).numpy()

    flip = flip_j(fwd, b0, bt) != flip_t(fwd_t, b0_t, bt_t)
    _check(TMU.rotate_stokes_basis(fwd_t, b0_t, bt_t),
           JMU.rotate_stokes_basis(fwd, b0, bt), "rotate_stokes_basis", flip)

    m = rng.normal(size=(N, 3, 4, 4)).astype(np.float32)
    m_t = torch.tensor(m)
    fwd2 = _units(rng)
    b2 = np.asarray(JMU.stokes_basis(fwd2))
    t2 = np.cross(fwd2, b2).astype(np.float32)
    fwd2_t, b2_t, t2_t = (torch.tensor(a) for a in (fwd2, b2, t2))
    flip2 = flip | (flip_j(fwd2, b2, t2) != flip_t(fwd2_t, b2_t, t2_t))
    _check(TMU.rotate_mueller_basis(m_t, fwd_t, b0_t, bt_t, fwd2_t, b2_t,
                                    t2_t),
           JMU.rotate_mueller_basis(m, fwd, b0, bt, fwd2, b2, t2),
           "rotate_mueller_basis", flip2)
    _check(TMU.rotate_mueller_basis_collinear(m_t, fwd_t, b0_t, bt_t),
           JMU.rotate_mueller_basis_collinear(m, fwd, b0, bt),
           "rotate_mueller_basis_collinear", flip)

    # to_world_mueller: random normals and local directions
    n, wi, wo = _units(rng), _units(rng), _units(rng)
    w_j = JMU.to_world_mueller(JFrame(n), m, -wo, wi)
    w_t = TMU.to_world_mueller(TFrame(torch.tensor(n)), m_t,
                               -torch.tensor(wo), torch.tensor(wi))
    # its two rotations' flip tests, evaluated as the function does
    fj, ft = JFrame(n), TFrame(torch.tensor(n))
    flip_w = np.zeros(N, bool)
    for d in (-wo, wi):
        dw_j = np.asarray(fj.to_world(d))
        dw_t = ft.to_world(torch.tensor(d))
        flip_w |= (flip_j(dw_j, np.asarray(fj.to_world(JMU.stokes_basis(d))),
                          np.asarray(JMU.stokes_basis(dw_j)))
                   != flip_t(dw_t, ft.to_world(TMU.stokes_basis(
                       torch.tensor(d))), TMU.stokes_basis(dw_t)))
    _check(w_t, w_j, "to_world_mueller", flip_w)
    for what, f in (("rotate", flip), ("rotate_mueller", flip2),
                    ("to_world", flip_w)):
        assert f.mean() <= FLIP_CAP, (what, f.mean())
