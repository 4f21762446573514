"""The port's SDF grids (`tpusky_torch/render/sdf.py`) and curves
(`render/curve.py`) against the JAX package on the CPU, the gradient of
an SDF hit to the grid's values against jax.grad, and what the new scene
fields may not reach: K4 (the megakernel gate), the particle tracer (R19)
and a measured row without its dataset.

At most 3 items, so that pytest-xdist's `--dist loadfile` hands this
file out after tests/test_multihost.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusky.render import curve as JC
from tpusky.render import sdf as JS
from tpusky.render.scene import make_scene

from tpusky_torch import convert
from tpusky_torch.render import curve as TC
from tpusky_torch.render import integrator as TI
from tpusky_torch.render import ptracer as TP
from tpusky_torch.render import sdf as TS
from tpusky_torch.render.film import Film

import torch_geometry_case as G
from torch_breadth_case import port, sunsky_state

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)

N = 4096


def _rays(rng, eye, lo, hi):
    """N rays from `eye` toward points uniform in the box [lo, hi]."""
    o = np.tile(np.asarray([eye], np.float32), (N, 1))
    tgt = rng.uniform(lo, hi, (N, 3)).astype(np.float32)
    d = tgt - o
    return o, d / np.linalg.norm(d, axis=1, keepdims=True)


def test_sdf_matches_jax():
    """A 16^3 torus grid, scaled and moved: the hit flags of
    `sdf_intersect` and `sdf_test` equal the reference's on >= 99.9% of
    4,096 rays; on the rays both hit, t within 1e-4 relative on >= 99.5%
    and 1e-3 on all, the normal within 1e-3 on >= 99.5% (the reference
    marches in a compiled loop, whose roundings move a step's end by an
    ulp); the gradient of the hits' t to the grid values within 1e-3 of
    jax.grad's scale; the gradient to the ray directions finite on every
    ray, where the reference's is NaN on the rays that miss the cube
    (R20), and within 1e-3 of its scale on the rays both hit."""
    rng = np.random.default_rng(1)
    jg = JS.make_sdf_grid(G.torus_grid(16), G.torus_to_world(), 1)
    tg = convert.sdf_grid(jax.tree.map(np.asarray, jg), device="cpu")
    own = TS.make_sdf_grid(G.torus_grid(16), G.torus_to_world(), 1,
                           device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tg[:3], own[:3]))
    assert tg.bsdf_idx == own.bsdf_idx == 1
    o, d = _rays(rng, (0.3, -3.0, 1.8), (-1.2, -1.2, 0.0), (1.2, 1.2, 2.0))
    jt, jn, jh = (np.asarray(x) for x in JS.sdf_intersect(
        jg, jnp.asarray(o), jnp.asarray(d)))
    tt, tn, th = (x.numpy() for x in TS.sdf_intersect(
        tg, torch.tensor(o), torch.tensor(d)))
    assert 0.2 < jh.mean() < 0.8 and (jh != th).mean() <= 1e-3
    both = jh & th
    rel = np.abs(tt[both] - jt[both]) / jt[both]
    assert rel.max() <= 1e-3 and (rel > 1e-4).mean() <= 5e-3
    assert (np.abs(tn - jn)[both].max(-1) > 1e-3).mean() <= 5e-3
    maxt = rng.uniform(0.0, 5.0, N).astype(np.float32)
    occ_j = np.asarray(JS.sdf_test(jg, jnp.asarray(o), jnp.asarray(d),
                                   jnp.asarray(maxt)))
    occ_t = TS.sdf_test(tg, torch.tensor(o), torch.tensor(d),
                        torch.tensor(maxt)).numpy()
    assert (occ_j != occ_t).mean() <= 1e-3

    sel = np.flatnonzero(both)[:256]

    def t_sum(v):
        t, _, _ = JS.sdf_intersect(jg._replace(values=v),
                                   jnp.asarray(o[sel]), jnp.asarray(d[sel]))
        return jnp.sum(t)
    g_j = np.asarray(jax.grad(t_sum)(jg.values))
    values = tg.values.clone().requires_grad_()
    t, _, hit = TS.sdf_intersect(tg._replace(values=values),
                                 torch.tensor(o[sel]), torch.tensor(d[sel]))
    g_t, = torch.autograd.grad(t.sum(), values)
    assert bool(hit.all())
    assert np.abs(g_t.numpy() - g_j).max() <= 1e-3 * np.abs(g_j).max()
    # R20: over every ray, misses included, the reference's gradient to
    # the ray directions is NaN where a ray misses the grid's cube (its
    # t_att / |d_local| is inf there); a render carries it into the grid
    # values through the previous vertex's SDF normal. The port's is
    # finite, and equal to the reference's on the lanes that hit.
    def t_hits(dirs):
        t, _, hit = JS.sdf_intersect(jg, jnp.asarray(o), dirs)
        return jnp.sum(jnp.where(hit, t, 0.0))
    g_j = np.asarray(jax.grad(t_hits)(jnp.asarray(d)))
    dirs = torch.tensor(d, requires_grad=True)
    t, _, hit = TS.sdf_intersect(tg, torch.tensor(o), dirs)
    g_t, = torch.autograd.grad(torch.where(hit, t, 0.0).sum(), dirs)
    assert bool(torch.isfinite(g_t).all()) and np.isnan(g_j).any()
    hit = hit.numpy() & jh
    assert np.abs(g_t.numpy() - g_j)[hit].max() <= 1e-3 * np.abs(
        g_j[hit]).max()


def test_curves_match_jax(tmp_path):
    """A tuft of 12 B-spline strands: the table equals the reference's
    bitwise and `read_curve_file` reads its format the same. Against the
    reference's walk evaluated op by op (`_round_cone_hits` a tile, merged
    by `<`), each tile's closest t, the hits, t and the materials are
    bitwise equal and the normals within 1e-5. Against its
    `curve_intersect` and `curve_test` (a compiled scan, whose contracted
    roundings move t by up to ~1e-4, a normal by that over the radius),
    the hit flags agree on >= 99.9% of 4,096 rays, t within 1e-3 relative
    and the material on every ray both hit, the winning segment (so the
    tangent) on >= 98% (the rest tie at a joint, where two segments share
    a cap)."""
    strands = G.tuft(12)
    jc = JC.make_curve_table(strands)
    tc = TC.make_curve_table(strands, device="cpu")
    for f in TC.CurveTable._fields:
        assert np.array_equal(getattr(tc, f).numpy(),
                              np.asarray(getattr(jc, f))), f
    assert torch.equal(convert.curve_table(jax.tree.map(np.asarray, jc),
                                           "cpu").pa, tc.pa)
    path = tmp_path / "hair.txt"
    path.write_text("0 0 0 0.1\n0 0 1 0.05\n\n1 2 3\n4 5 6 0.2\n")
    assert all(np.array_equal(a, b) for x, y in zip(
        TC.read_curve_file(str(path)), JC.read_curve_file(str(path)))
        for a, b in zip(x, y))

    rng = np.random.default_rng(2)
    o, d = _rays(rng, (0.9, -3.5, 0.6), (0.5, -1.0, 0.0), (1.3, -0.2, 1.2))
    # the reference's walk, op by op: each tile's best, merged by `<`
    best = (np.full(N, np.inf, np.float32), np.zeros((N, 3), np.float32),
            np.full(N, -1))
    for tile in range(tc.pa.shape[0] // 128):
        jt, jn, local, _ = (np.asarray(x) for x in JC._round_cone_hits(
            jc, tile, jnp.asarray(o), jnp.asarray(d)))
        assert np.array_equal(TC._tile_t(tc, tile, torch.tensor(o),
                                         torch.tensor(d)).min(-1)[0].numpy(),
                              jt)
        closer = jt < best[0]
        best = (np.where(closer, jt, best[0]),
                np.where(closer[:, None], jn, best[1]),
                np.where(closer, tile * 128 + local, best[2]))
    tr = [x.numpy() for x in TC.curve_intersect(tc, torch.tensor(o),
                                                torch.tensor(d))]
    hit = np.isfinite(best[0])
    assert 0.1 < hit.mean() and np.array_equal(tr[3], hit)
    assert np.array_equal(tr[0], best[0])
    assert np.abs(tr[1] - best[1])[hit].max() <= 1e-5
    assert np.array_equal(tr[2][hit], np.asarray(jc.bsdf_idx)[best[2][hit]])
    jr = [np.asarray(x) for x in JC.curve_intersect(jc, jnp.asarray(o),
                                                    jnp.asarray(d))]
    assert (jr[3] != tr[3]).mean() <= 1e-3
    both = jr[3] & tr[3]
    assert (np.abs(tr[0][both] - jr[0][both]) / jr[0][both]).max() <= 1e-3
    assert np.array_equal(tr[2][both], jr[2][both])
    assert (np.abs(tr[4] - jr[4]).max(-1) <= 1e-6)[both].mean() >= 0.98
    maxt = rng.uniform(0.0, 5.0, N).astype(np.float32)
    occ_j = np.asarray(JC.curve_test(jc, jnp.asarray(o), jnp.asarray(d),
                                     jnp.asarray(maxt)))
    occ_t = TC.curve_test(tc, torch.tensor(o), torch.tensor(d),
                          torch.tensor(maxt)).numpy()
    assert (occ_j != occ_t).mean() <= 1e-3


def test_refusals_and_the_k4_gate():
    """A direct-illumination RGB frame of diffuse shapes under the sunsky
    passes K4's rules, and the same frame with an SDF grid or curves does
    not (the reference refuses both, `tpusky/render/integrator.py:
    955-957`); `convert.scene` carries both fields over; the particle
    tracer refuses curves (R19: the reference's walk never meets them,
    its shadow rays do) and renders an SDF scene; a render of a measured
    row whose dataset was dropped raises ValueError before tracing."""
    sc_j = make_scene(shapes=[G.ground()], env=sunsky_state(),
                      bsdf_albedos=[[0.4] * 3, [0.6, 0.2, 0.2]],
                      sdf=JS.make_sdf_grid(G.torus_grid(8),
                                           G.torus_to_world(), 1),
                      curves=G.tuft(2, bsdf_idx=1))
    sensor_j = G.camera()
    sc, sensor = port(sc_j, sensor_j)
    assert sc.sdf is not None and sc.curve is not None
    assert sc.curve.pa.shape == (128, 3) and sc.sdf.bsdf_idx == 1
    film = Film(8, 8, 3)
    kinds = ((0,), False)
    plain = sc._replace(sdf=None, curve=None)
    args = (sensor, film, 4, 2, "rgb", "independent", kinds, 1000)
    assert TI._megakernel_rules(plain, *args)
    for bad in (sc, plain._replace(sdf=sc.sdf),
                plain._replace(curve=sc.curve)):
        assert not TI._megakernel_rules(bad, *args)
    with pytest.raises(NotImplementedError, match="R19"):
        TP.render_ptracer(sc, sensor, film, 1, 256)
    img = TP.render_ptracer(sc._replace(curve=None), sensor, film, 1, 256)
    assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all())
    b = sc.bsdfs
    dropped = sc._replace(bsdfs=b._replace(host_kind=b.host_kind + (17,)))
    with pytest.raises(ValueError, match="measured dataset"):
        TI.render(dropped, sensor, film, 1, spp=1)
