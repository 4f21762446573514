"""The forward-mode rules of the kernels' autograd Functions on the CPU:
with each kernel's launch stood in by its plain version (the card is not
here), the tangents that `_Eval`, `_Hit`, `_Nee` (K1-K3), `_EvalSpec`,
`_HitSpec`, `_NeeSpec` (K9-K11) and `integrator._Megakernel` (K4) give
under `torch.autograd.forward_ad` are forward-mode AD of the plain path
bitwise: the rules take the plain version's tangent in the state the
tables come from and in the lanes, with the pdf's tangent where it is
attached and none where it is detached, and K4's from the replayed
wavefront. On the card the primal is the kernel's (chip_smoke.py phase
25 holds the tangents there).

At most 3 items, so that pytest-xdist's `--dist loadfile` hands this
file out after tests/test_multihost.py.
"""

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

import tpusky_torch as tt
from tpusky_torch.models.sunsky import model as M
from tpusky_torch.ops.cuda import megakernel as MK
from tpusky_torch.ops.cuda import sunsky_kernel as K
from tpusky_torch.render import integrator
from tpusky_torch.render.film import Film
from tpusky_torch.render.scene import make_scene
from tpusky_torch.render.sensors import make_perspective

torch.set_num_threads(1)

SUN = [0.3, 0.2, 0.93]


def _detached(fn):
    def launch(*args):
        out = fn(*args)
        return tuple(o.detach() for o in out) if isinstance(out, tuple) \
            else out.detach()
    return launch


def _tangents(outs):
    return {k: [fwAD.unpack_dual(x).tangent for x in
                (v if isinstance(v, tuple) else (v,))]
            for k, v in outs.items()}


@pytest.mark.parametrize("mode", ["rgb", "spectral"])
def test_sunsky_function_tangents_are_the_plain_tangents(mode,
                                                         monkeypatch):
    """K1-K3 (or K9-K11) through their Functions, pdf detached and
    attached, at 4,096 random directions, uniforms and (spectral)
    wavelengths, every parameter and lane with a seeded tangent: each
    output's tangent bitwise the plain version's, None exactly where the
    plain version has none."""
    gen = torch.Generator().manual_seed(0)
    tables = tt.load_tables(mode, device="cpu")
    p = tt.make_params(turbidity=3.0, albedo=0.3, sun_direction=SUN,
                       mode=mode, device="cpu")
    tang = {f: torch.randn(getattr(p, f).shape, generator=gen)
            for f in p._fields}
    n = 4096
    d = torch.randn(n, 3, generator=gen)
    d = d / d.norm(dim=-1, keepdim=True)
    t_d = torch.randn(n, 3, generator=gen)
    u2 = torch.rand(n, 2, generator=gen)
    wl = 360.0 + 400.0 * torch.rand(n, 4, generator=gen)
    t_wl = torch.randn(n, 4, generator=gen)

    def run(kernel):
        out = {}
        with fwAD.dual_level():
            st = M.precompute(tables, p._replace(**{
                f: fwAD.make_dual(getattr(p, f), tang[f])
                for f in p._fields}), mode)
            dd = fwAD.make_dual(d, t_d)
            spec = mode == "spectral"
            lanes = (fwAD.make_dual(wl, t_wl),) if spec else ()
            plain = ((M._eval_spec_plain, M._hit_spec_plain,
                      M._sample_eval_spec_plain) if spec else
                     (M._eval_rgb_plain, M._hit_rgb_plain,
                      M._sample_eval_rgb_plain))
            if kernel:
                names = (("launch_eval_spec", "launch_hit_spec",
                          "launch_nee_spec") if spec else
                         ("launch_eval", "launch_hit", "launch_nee"))
                for name, fn in zip(names, plain):
                    monkeypatch.setattr(K, name, _detached(
                        lambda _tables, *x, fn=fn: fn(st, *x)))
                pack = K.pack_tables_spec if spec else K.pack_tables
                ev, hit, nee = ((K._EvalSpec, K._HitSpec, K._NeeSpec) if spec
                                else (K._Eval, K._Hit, K._Nee))
                tab = pack(st, "cpu")
                out["eval"] = ev.apply(st, dd, *lanes,
                                       *(tab if spec else tab[:4]))
                for det in (True, False):
                    tab = pack(st, "cpu", not det)
                    out[f"hit {det}"] = hit.apply(st, det, dd, *lanes, *tab)
                    out[f"nee {det}"] = nee.apply(st, det, u2, *lanes, *tab)
            else:
                out["eval"] = plain[0](st, dd, *lanes)
                for det in (True, False):
                    r, pdf = plain[1](st, dd, *lanes)
                    out[f"hit {det}"] = (r, pdf.detach() if det else pdf)
                    dn, r, pdf = plain[2](st, u2, *lanes)
                    out[f"nee {det}"] = (dn, r, pdf.detach() if det else pdf)
            return _tangents(out)
    got, want = run(True), run(False)
    for key, outs in want.items():
        for i, (a, b) in enumerate(zip(got[key], outs)):
            assert (a is None) == (b is None), (key, i)
            if b is not None:
                assert torch.equal(a, b), (key, i)
    assert all(want[f"nee {det}"][1] is not None for det in (True, False))


def test_megakernel_tangent_is_the_replay_tangent(monkeypatch):
    """`_Megakernel` on the headline scene (16x16x4, depth 2) with K4
    stood in by the plain wavefront: the film's tangent in the sunsky's
    parameters and the sphere's to_world bitwise forward-mode AD of
    render_rows, its primal the stand-in's."""
    tables = tt.load_tables("rgb", device="cpu")
    p = tt.make_params(turbidity=3.0, albedo=0.3, sun_direction=SUN,
                       device="cpu")
    ground = np.diag([10.0, 10.0, 1.0, 1.0]).astype(np.float32)
    sphere = np.eye(4, dtype=np.float32)
    sphere[2, 3] = 1.0
    sensor = make_perspective([4, -4, 2.0], [0, 0, 1.0], fov_x_deg=45,
                              device="cpu")
    film = Film(16, 16, 3)
    kinds = integrator._DIFFUSE_ONLY
    gen = torch.Generator().manual_seed(2)
    t_p = {f: torch.randn(getattr(p, f).shape, generator=gen)
           for f in p._fields}
    t_w = torch.randn(4, 4, generator=gen) * 0.1

    def scene_of(pd, w):
        sc = make_scene(shapes=[dict(kind=1, to_world=ground, bsdf_idx=0),
                                dict(kind=0, to_world=sphere, bsdf_idx=1)],
                        bsdf_albedos=[[0.4] * 3, [0.6, 0.2, 0.2]],
                        env=M.precompute(tables, pd, "rgb"), device="cpu")
        t2w = torch.cat([sc.shapes.to_world[:1], w[None]], 0)
        return sc._replace(shapes=sc.shapes._replace(
            to_world=t2w, to_object=torch.linalg.inv(t2w)))

    def rows(sc):
        return integrator.render_rows(sc, sensor, film, 1, 4, 2, 1000, "rgb",
                                      0, 16, kinds=kinds)
    monkeypatch.setattr(MK, "direct_rgb_megakernel", lambda sc, se, env,
                        seed, spp, w, h: rows(sc).detach())
    out = {}
    for kernel in (True, False):
        with fwAD.dual_level():
            pd = p._replace(**{f: fwAD.make_dual(getattr(p, f), t_p[f])
                               for f in p._fields})
            sc = scene_of(pd, fwAD.make_dual(torch.as_tensor(sphere), t_w))
            if kernel:
                leaves = []
                struct = (integrator._flatten(sc, leaves),
                          integrator._flatten(sensor, leaves))
                cfg = (film, 1, 4, 2, 1000, "rgb", "independent", kinds)
                acc = integrator._Megakernel.apply(cfg, struct, *leaves)
            else:
                acc = rows(sc)
            out[kernel] = fwAD.unpack_dual(acc)
    assert torch.equal(out[True].primal, out[False].primal)
    assert out[False].tangent.abs().max() > 0
    assert torch.equal(out[True].tangent, out[False].tangent)
