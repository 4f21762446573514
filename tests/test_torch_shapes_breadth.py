"""The port's cube and cylinder, shape areas, area sampling and area
emitters' pdfs (`tpusky_torch.render.shapes`, `render.emitters`) against
the JAX package on the CPU, on the same numpy-seeded inputs.

At most 3 items, so that pytest-xdist's `--dist loadfile` hands this
file out after tests/test_multihost.py and it adds nothing to the wall.
"""

import jax
import numpy as np
import pytest
import torch

from tpusky.render import emitters as JE
from tpusky.render import shapes as JSH
from tpusky.render.scene import make_scene as jax_make_scene

from tpusky_torch import convert
from tpusky_torch.render import emitters as TE
from tpusky_torch.render import shapes as TSH
from tpusky_torch.render.scene import make_scene

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)


def _affine(rng, uniform=False):
    """A rotation times a (non-)uniform scale, and a translation."""
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    s = rng.uniform(0.5, 1.8) * np.ones(3) if uniform else \
        rng.uniform(0.5, 1.8, 3)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = q * s
    m[:3, 3] = rng.uniform(-1.0, 1.0, 3)
    return m


def _rel_close(a, b, tol):
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol)


def test_cube_cylinder_intersect_match_jax():
    """4,096 rays against a cube, a cylinder and both (rotated, scaled
    non-uniformly), a quarter of the origins inside a shape: hit flags
    and shape indices equal, the shadow test equal, t, p and n within
    1e-5 of max(t, 1) (p = o + t d, and a cylinder's normal is its hit
    point's xy, so both carry t's error). A grazing hit (|cos| < 0.05 between the ray and the
    normal) turns the quadratic's ulps into 1/sqrt(discriminant) error,
    so there they are held within 1e-4, the bar of
    tests/test_torch_render.py's analytic shapes."""
    rng = np.random.default_rng(4)
    for kinds in ((3,), (4,), (4, 3)):
        shapes = [dict(kind=k, to_world=_affine(rng), bsdf_idx=i)
                  for i, k in enumerate(kinds)]
        table_j = JSH.make_shape_table(shapes)
        table_t = convert.shape_table(jax.tree.map(np.asarray, table_j),
                                      device="cpu")
        n = 4096
        o = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
        # a quarter start inside the first shape: its object-space
        # interior mapped to the world
        inside = np.c_[rng.uniform(-0.5, 0.5, (n // 4, 2)),
                       rng.uniform(0.1, 0.9, n // 4)].astype(np.float32)
        m = shapes[0]["to_world"]
        o[: n // 4] = inside @ m[:3, :3].T + m[:3, 3]
        d = rng.uniform(-1.5, 1.5, (n, 3)) - o
        d[: n // 4] = rng.normal(size=(n // 4, 3))
        d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(
            np.float32)
        maxt = rng.uniform(0.2, 6.0, n).astype(np.float32)
        t_j, p_j, n_j, _uv, idx_j, hit_j = (np.asarray(x) for x in jax.jit(
            JSH.ray_intersect)(table_j, o, d))
        t_t, p_t, n_t, idx_t, hit_t = (x.numpy() for x in TSH.ray_intersect(
            table_t, torch.tensor(o), torch.tensor(d)))
        np.testing.assert_array_equal(hit_t, hit_j)
        np.testing.assert_array_equal(idx_t, idx_j)
        assert 0.2 < hit_t.mean() < 0.9 and hit_t[: n // 4].mean() > 0.3
        steep = np.abs((d * n_j).sum(-1)) >= 0.05
        assert steep[hit_j].mean() > 0.95
        scale = np.maximum(np.where(hit_j, t_j, 0.0), 1.0)
        t_t, t_j = np.where(hit_t, t_t, 0.0), np.where(hit_j, t_j, 0.0)
        errs = (np.abs(t_t - t_j) / scale,
                np.abs(p_t - p_j).max(-1) / scale,    # p = o + t d
                np.abs(n_t - n_j).max(-1) / scale)   # a cylinder's: p's xy
        for err in errs:
            assert err.max() <= 1e-4
            assert err[steep].max() <= 1e-5
        occ_j = np.asarray(jax.jit(JSH.ray_test)(table_j, o, d, maxt))
        occ_t = TSH.ray_test(table_t, torch.tensor(o), torch.tensor(d),
                             torch.tensor(maxt)).numpy()
        np.testing.assert_array_equal(occ_t, occ_j)


def test_area_and_sample_position_match_jax():
    """`_world_area` of all five kinds under non-uniform transforms
    (spheres and cylinders also under uniform ones) within 1e-6 relative;
    `sample_position` on a rectangle, a disk, a sphere and a cylinder at
    the same u2 within 1e-5; an area emitter on a cube is refused, naming
    R8 (the reference samples it as the sphere inside it)."""
    rng = np.random.default_rng(8)
    for kind in range(5):
        for uniform in (False, True):
            m = _affine(rng, uniform)
            np.testing.assert_allclose(TSH._world_area(kind, m),
                                       JSH._world_area(kind, m), rtol=1e-6)
    shapes = [dict(kind=k, to_world=_affine(rng, k in (0, 4)), bsdf_idx=0,
                   emitter_idx=i) for i, k in enumerate((1, 2, 0, 4))]
    table_j = JSH.make_shape_table(shapes)
    table_t = TSH.make_shape_table(shapes, device="cpu")
    np.testing.assert_allclose(table_t.area.numpy(),
                               np.asarray(table_j.area), rtol=1e-6)
    idx = rng.integers(0, 4, 4096)
    u2 = rng.random((4096, 2), dtype=np.float32)
    ref = [np.asarray(x) for x in jax.jit(JSH.sample_position)(
        table_j, idx.astype(np.int32), u2)]
    out = [x.numpy() for x in TSH.sample_position(
        table_t, torch.tensor(idx), torch.tensor(u2))]
    for a, b in zip(out, ref):
        _rel_close(a, b, 1e-5)
    cube = [dict(kind=3, to_world=np.eye(4), emitter_idx=0)]
    with pytest.raises(NotImplementedError, match="R8"):
        TSH.make_shape_table(cube, device="cpu")
    with pytest.raises(NotImplementedError, match="R8"):
        convert.shape_table(jax.tree.map(
            np.asarray, JSH.make_shape_table(cube)), device="cpu")


def test_area_sampling_matches_jax():
    """`area_sample_direction` from 4,096 points toward four emitters (a
    rectangle, a disk, a sphere, a cylinder) and `area_pdf_direction` at
    the sampled points, against the reference within 1e-5 relative. The
    solid-angle pdf divides by the emitter's cosine, which turns its
    ulps into 1/cos relative error at grazing samples: there (cos < 0.05)
    the pdfs are held within 1e-3."""
    rng = np.random.default_rng(9)
    shapes = [dict(kind=1, to_world=np.diag([10.0, 10.0, 1.0, 1.0]),
                   bsdf_idx=0)]
    shapes += [dict(kind=k, to_world=_affine(rng, k in (0, 4)), bsdf_idx=0,
                    emitter_idx=i) for i, k in enumerate((1, 2, 0, 4))]
    for s in shapes[1:]:
        s["to_world"][2, 3] += 3.0
    rad = rng.uniform(1.0, 5.0, (5, 3)).astype(np.float32)
    rad[0] = 0.0
    sc_j = jax_make_scene(shapes=shapes, area_radiance=rad)
    sc_t = make_scene(shapes=shapes, area_radiance=rad, device="cpu")
    n = 4096
    p = rng.uniform(-2.0, 2.0, (n, 3)).astype(np.float32)
    p[:, 2] = rng.uniform(0.0, 1.0, n)
    u2 = rng.random((n, 2), dtype=np.float32)
    u1 = rng.random(n, dtype=np.float32)
    ref = [np.asarray(x) for x in jax.jit(JE.area_sample_direction)(
        sc_j, p, u2, u1)]
    out = [x.numpy() for x in TE.area_sample_direction(
        sc_t, torch.tensor(p), torch.tensor(u2), torch.tensor(u1))]
    np.testing.assert_array_equal(out[5], ref[5])
    assert len(set(out[5].tolist())) == 4 and (out[2] > 0).mean() > 0.15
    steep = (out[4] * -out[0]).sum(-1) >= 0.05
    assert steep.mean() > 0.1
    for i, (a, b) in enumerate(zip(out[:5], ref[:5])):
        if i == 2:
            _rel_close(a, b, 1e-3)
            a, b = a[steep], b[steep]
        _rel_close(a, b, 1e-5)
    p_hit = (p + out[1][:, None] * out[0]).astype(np.float32)
    pdf_j = np.asarray(jax.jit(JE.area_pdf_direction)(
        sc_j, p, p_hit, out[4], out[5].astype(np.int32)))
    pdf_t = TE.area_pdf_direction(sc_t, torch.tensor(p),
                                  torch.tensor(p_hit), torch.tensor(out[4]),
                                  torch.tensor(out[5])).numpy()
    _rel_close(pdf_t, pdf_j, 1e-3)
    _rel_close(pdf_t[steep], pdf_j[steep], 1e-5)
    _rel_close(pdf_t[steep], out[2][steep], 1e-4)
