"""The port's textures (`tpusky_torch/render/texture.py`), uv at analytic
hits and the mesh's uv and colour interpolation against the JAX package
on the CPU, from numpy-seeded inputs; with them the cases of
tests/test_texture.py and tests/test_texture_extra.py that need no
loader.

At most 3 items, so that pytest-xdist's `--dist loadfile` hands this
file out after tests/test_multihost.py and it adds nothing to the wall.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tpusky.render import mesh as JMESH
from tpusky.render import shapes as JSH
from tpusky.render import texture as JT

from tpusky_torch import convert
from tpusky_torch.ops.rgb2spec import (eval_sigmoid_spectrum,
                                      fit_sigmoid_coeffs,
                                      fit_sigmoid_coeffs_f64)
from tpusky_torch.render import mesh as TMESH
from tpusky_torch.render import shapes as TSH
from tpusky_torch.render import texture as TT
from tpusky_torch.utils.meshio import icosphere

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)

N = 8192


def _textures(rng):
    """Every kind and wrap: a checker under a sheared `to_uv`, bitmaps of
    3, 1 and 3 channels wrapped repeat, mirror and clamp (one scaled by
    `to_uv`), a volume under a `to_world`, a scaled mesh attribute."""
    t2w = np.diag([2.0, 1.5, 2.5, 1.0]).astype(np.float32)
    t2w[:3, 3] = [-1.0, -0.8, -1.2]
    return [dict(kind="checkerboard", color0=[0.9, 0.2, 0.1],
                 color1=[0.1, 0.3, 0.8],
                 to_uv=[[3.0, 0.5, 0.1], [0.2, 4.0, 0.3], [0.0, 0.0, 1.0]]),
            dict(kind="bitmap", data=rng.uniform(size=(7, 5, 3)),
                 wrap="repeat"),
            dict(kind="bitmap", data=rng.uniform(size=(4, 9)),
                 wrap="mirror", to_uv=np.diag([1.7, 2.3, 1.0])),
            dict(kind="bitmap", data=rng.uniform(size=(6, 6, 3)),
                 wrap="clamp"),
            dict(kind="volume", grid=rng.uniform(size=(3, 4, 5, 3)),
                 to_world=t2w),
            dict(kind="mesh_attribute", scale=1.5)]


def _as_f32(textures):
    return [{k: (np.asarray(v, np.float32) if k in ("data", "grid") else v)
             for k, v in d.items()} for d in textures]


def test_texture_table_matches_jax():
    """`make_texture_table` against the reference's, RGB and spectral:
    every column equal, the coefficient atlas within 1e-6 of each
    coefficient's magnitude (floor 1; the reference fits on the host in
    float64, the port with `fit_sigmoid_coeffs_f64` on the table's device,
    the same rule, here held against the host fit: spectra within 1e-7,
    coefficients within 1e-9 of their magnitude but white's); the host
    copy of the kinds; `convert.texture_table` carries the reference's
    table over unchanged."""
    rng = np.random.default_rng(11)
    textures = _as_f32(_textures(rng))
    for spectral in (False, True):
        jt = JT.make_texture_table(textures, spectral=spectral)
        tt = TT.make_texture_table(textures, spectral=spectral, device="cpu")
        for f in JT.TextureTable._fields:
            a, b = np.asarray(getattr(jt, f)), getattr(tt, f).numpy()
            assert a.shape == b.shape, f
            if f == "atlas_coeff":
                assert (np.abs(a - b) <= 1e-6 * np.maximum(np.abs(a), 1.0)
                        ).all(), np.abs(a - b).max()
            else:
                assert (a == b).all(), f
        assert tt.host_kind == (0, 1, 1, 1, 2, 3)
        assert TT.table_texture_kinds(tt) == JT.table_texture_kinds(jt)
        ct = convert.texture_table(jax.tree.map(np.asarray, jt), "cpu")
        assert ct.host_kind == tt.host_kind
        assert all(torch.equal(getattr(ct, f), getattr(tt, f))
                   for f in TT.TextureTable._fields[:-1]
                   if f != "atlas_coeff")
        assert ct.kind.dtype == torch.int64
    assert TT.table_texture_kinds(None) == ()
    rgb = rng.uniform(size=(2048, 3))
    rgb[:4] = [[0.5] * 3, [1.0, 0.0, 0.0], [0.0] * 3, [1.0] * 3]
    host = fit_sigmoid_coeffs(rgb)
    dev = fit_sigmoid_coeffs_f64(torch.tensor(rgb)).numpy()
    wl = np.linspace(360.0, 830.0, 95)
    assert np.abs(eval_sigmoid_spectrum(host, wl)
                  - eval_sigmoid_spectrum(dev, wl)).max() <= 1e-7
    # white diverges to |c| ~ 1e6, where the two solves part at 4e-5
    err = np.abs(host - dev) / np.maximum(np.abs(host), 1.0)
    assert err[4:].max() <= 1e-9 and err[3].max() <= 1e-4


def _edge_lanes(tt, idx, uv):
    """Lanes whose bitmap sample point lies within 1e-5 texel of a texel
    centre, where the bilinear cell floor(u w - 0.5) changes and may round
    either way: XLA:CPU may fuse the reference's multiply-add, torch does
    not."""
    i = np.maximum(idx, 0)
    uv = np.nan_to_num(uv, nan=0.5, posinf=0.5)
    m = tt.uv_transform.numpy()[i].astype(np.float64)
    w = tt.width.numpy()[i]
    h = tt.height.numpy()[i]
    u = m[:, 0, 0] * uv[:, 0] + m[:, 0, 1] * uv[:, 1] + m[:, 0, 2]
    v = m[:, 1, 0] * uv[:, 0] + m[:, 1, 1] * uv[:, 1] + m[:, 1, 2]
    fx, fy = u * w - 0.5, v * h - 0.5
    near = (np.abs(fx - np.round(fx)) < 1e-5) | \
        (np.abs(fy - np.round(fy)) < 1e-5)
    return near & (tt.kind.numpy()[i] == TT.BITMAP) & (idx >= 0)


def _reference_cases():
    """tests/test_texture.py's and test_texture_extra.py's oracles, on
    the port."""
    def ev(textures, idx, uv, **kw):
        tt = TT.make_texture_table(textures, kw.pop("spectral", False),
                                   device="cpu")
        v, h = TT.eval_texture(tt, torch.tensor(idx),
                               torch.tensor(uv, dtype=torch.float32), **kw)
        return v.numpy(), h.numpy()
    quad = [[0.25, 0.25], [0.75, 0.25], [0.25, 0.75], [0.75, 0.75]]
    v, h = ev([dict(kind="checkerboard", color0=[1.0, 0.0, 0.0],
                    color1=[0.0, 1.0, 0.0])], [0] * 4, quad)
    assert h.all()
    np.testing.assert_allclose(v, [[1, 0, 0], [0, 1, 0], [0, 1, 0],
                                   [1, 0, 0]], atol=1e-6)
    v, _ = ev([dict(kind="checkerboard", color0=[1, 1, 1], color1=[0, 0, 0],
                    to_uv=np.diag([2.0, 2.0, 1.0]))], [0, 0],
              [[0.2, 0.2], [0.45, 0.2]])
    np.testing.assert_allclose(v, [[1, 1, 1], [0, 0, 0]], atol=1e-6)
    img = np.arange(12, dtype=np.float32).reshape(2, 2, 3) / 12.0
    v, _ = ev([dict(kind="bitmap", data=img)], [0] * 4, quad)
    np.testing.assert_allclose(v, img.reshape(4, 3), atol=1e-6)
    img = np.zeros((1, 2, 3), np.float32)
    img[0, 1] = 1.0
    v, _ = ev([dict(kind="bitmap", data=img, wrap="clamp")], [0],
              [[0.5, 0.5]])
    np.testing.assert_allclose(v[0], [0.5] * 3, atol=1e-6)
    img = np.zeros((1, 2, 3), np.float32)
    img[0, 0], img[0, 1] = [1, 0, 0], [0, 1, 0]
    for wrap, want in (("repeat", [1, 0, 0]), ("clamp", [0, 1, 0])):
        v, _ = ev([dict(kind="bitmap", data=img, wrap=wrap)], [0],
                  [[1.25, 0.5]])
        np.testing.assert_allclose(v[0], want, atol=1e-6)
    v, _ = ev([dict(kind="bitmap", data=np.full((2, 2, 3), 0.25, np.float32)),
               dict(kind="bitmap", data=np.full((4, 4, 3), 0.75,
                                                np.float32))],
              [0, 1], [[0.5, 0.5]] * 2)
    np.testing.assert_allclose(v, [[0.25] * 3, [0.75] * 3], atol=1e-6)
    _, h = ev([dict(kind="checkerboard")], [-1, 0], [[0.0, 0.0]] * 2)
    assert not h[0] and h[1]
    wl = torch.tensor([[450.0, 550.0, 600.0, 700.0]])
    v, _ = ev([dict(kind="bitmap", data=np.full((1, 1, 3), 0.5,
                                                np.float32))],
              [0], [[0.5, 0.5]], wavelengths=wl, spectral=True)
    np.testing.assert_allclose(v[0], 0.5, atol=0.02)
    v, _ = ev([dict(kind="checkerboard", color0=[0.8] * 3,
                    color1=[0.1] * 3)], [0], [[0.25, 0.25]], wavelengths=wl)
    np.testing.assert_allclose(v[0], 0.8, atol=0.05)
    grid = np.zeros((2, 2, 2, 3), np.float32)
    grid[0, 0, 0], grid[1, 1, 1] = [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]
    v, h = ev([dict(kind="volume", grid=grid)], [0] * 3, [[0.0, 0.0]] * 3,
              p=torch.tensor([[0.25] * 3, [0.75] * 3, [0.5] * 3]))
    assert h.all()
    np.testing.assert_allclose(v, [[1, 0, 0], [0, 0, 1],
                                   grid.mean((0, 1, 2))], atol=1e-6)
    t2w = np.eye(4, dtype=np.float32)
    t2w[:3, 3] = [10.0, 0.0, 0.0]
    v, _ = ev([dict(kind="volume", grid=np.full((1, 1, 1, 3), 0.7,
                                                np.float32), to_world=t2w)],
              [0], [[0.0, 0.0]], p=torch.tensor([[10.5, 0.5, 0.5]]))
    np.testing.assert_allclose(v[0], 0.7, atol=1e-6)
    v, _ = ev([dict(kind="mesh_attribute", scale=2.0)], [0], [[0.0, 0.0]],
              attr=torch.tensor([[0.1, 0.2, 0.3]]))
    np.testing.assert_allclose(v[0], [0.2, 0.4, 0.6], atol=1e-6)


def test_eval_texture_matches_jax():
    """`eval_texture` on 8,192 lanes of every kind and wrap (uv in
    [-1.5, 2.5], 64 non-finite, negative indices, lanes on texel
    centres, world points in and around the volume, vertex colours)
    against the reference's: `has` equal, RGB within 1e-6, the spectral
    values at 4 wavelengths within 1e-5 of the lane's scale (its largest
    value, floor 1e-3: a small bilinear value keeps the rounding of its
    large taps, 6e-8 on taps of 0.9, as in both packages), except
    bitmap lanes within 1e-5 texel of a texel centre, counted and held
    to 1e-3 of the lanes (there both sides interpolate continuously
    across the centre, so even they agree to 1e-4). A texture without its
    input (a volume without p, an attribute without colours) reads as the
    reference's; the atlas's gradient is finite on non-finite lanes. Then
    the reference's own oracle cases."""
    rng = np.random.default_rng(12)
    textures = _as_f32(_textures(rng))
    idx = rng.integers(-1, len(textures), size=N)
    uv = rng.uniform(-1.5, 2.5, size=(N, 2)).astype(np.float32)
    uv[:32] = np.nan
    uv[32:64, 0] = np.inf
    # lanes at texel centres of the repeat bitmap (7 x 5), where the
    # bilinear cell changes
    idx[64:256] = 1
    uv[64:256] = ((rng.integers(-5, 12, size=(192, 2)) + 0.5)
                  / [5.0, 7.0]).astype(np.float32)
    p = rng.uniform(-1.5, 1.8, size=(N, 3)).astype(np.float32)
    attr = rng.uniform(size=(N, 3)).astype(np.float32)
    wl = rng.uniform(360.0, 830.0, size=(N, 4)).astype(np.float32)
    for spectral in (False, True):
        jt = JT.make_texture_table(textures, spectral=spectral)
        tt = TT.make_texture_table(textures, spectral=spectral, device="cpu")
        edge = _edge_lanes(tt, idx, uv.astype(np.float64))
        assert edge[64:256].sum() >= 100
        for with_inputs in (True, False):
            kw_j = dict(p=jnp.asarray(p), attr=jnp.asarray(attr)) \
                if with_inputs else {}
            kw_t = dict(p=torch.tensor(p), attr=torch.tensor(attr)) \
                if with_inputs else {}
            vj, hj = JT.eval_texture(
                jt, jnp.asarray(idx, jnp.int32), jnp.asarray(uv),
                jnp.asarray(wl) if spectral else None,
                tkinds=JT.table_texture_kinds(jt), **kw_j)
            vt, ht = TT.eval_texture(
                tt, torch.tensor(idx), torch.tensor(uv),
                torch.tensor(wl) if spectral else None, **kw_t)
            vj, hj, vt = np.asarray(vj), np.asarray(hj), vt.numpy()
            assert (hj == ht.numpy()).all() and hj.sum() > 0.8 * N
            scale = np.maximum(np.abs(vj).max(-1, keepdims=True), 1e-3)
            err = np.abs(vt - vj) / (scale if spectral else 1.0)
            bar = 1e-5 if spectral else 1e-6
            off = hj & (err.max(-1) > bar)
            assert not (off & ~edge).any(), np.nonzero(off & ~edge)
            assert off.sum() <= 1e-3 * N and err[off].max(initial=0) < 1e-4
    # the atlas's gradient stays finite where the uv is not
    tt = TT.make_texture_table(textures, device="cpu")
    atlas = tt.atlas.clone().requires_grad_()
    v, h = TT.eval_texture(tt._replace(atlas=atlas), torch.tensor(idx),
                           torch.tensor(uv), p=torch.tensor(p),
                           attr=torch.tensor(attr))
    (g,) = torch.autograd.grad(torch.where(h[:, None], v, 0.0).sum(), atlas)
    assert torch.isfinite(g).all() and g.abs().sum() > 0
    _reference_cases()


def test_uv_at_hits_matches_jax():
    """uv at analytic hits (sphere, rectangle, disk, cube, cylinder, each
    alone so that every lane's closest shape is that kind) and
    `mesh_interp_uv` / `mesh_interp_color` at the reference's hits on an
    icosphere (triangle and barycentrics given to both), against
    the reference's on 4,096 rays: within 1e-6 on hit lanes (a sphere's
    and a cylinder's longitude within 1e-6 of a turn, 0 and 1 being one
    seam), 0 on a miss; without `uv` ray_intersect returns what it did."""
    rng = np.random.default_rng(13)
    n = 4096
    o = rng.normal(size=(n, 3)).astype(np.float32) * 0.4
    o[:, 2] += 3.0
    target = rng.uniform(-1.4, 1.4, size=(n, 3)).astype(np.float32)
    target[:, 2] = rng.uniform(-0.5, 1.2, size=n)
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t2w = np.diag([1.1, 0.9, 1.2, 1.0]).astype(np.float32)
    t2w[:3, 3] = [0.1, -0.05, 0.1]
    for kind in TSH.KINDS:
        shapes = [dict(kind=kind, to_world=t2w, bsdf_idx=0)]
        js = JSH.make_shape_table(shapes)
        ts_ = TSH.make_shape_table(shapes, device="cpu")
        _, _, _, uv_j, idx_j, hit_j = (np.asarray(x) for x in
                                       JSH.ray_intersect(js, o, d))
        out = TSH.ray_intersect(ts_, torch.tensor(o), torch.tensor(d),
                                uv=True)
        uv_t, idx_t, hit_t = (x.numpy() for x in out[3:])
        assert (hit_j == hit_t).all() and (idx_j == idx_t).all()
        assert hit_j.mean() > 0.2, kind
        du = np.abs(uv_t - uv_j)
        du[:, 0] = np.minimum(du[:, 0], 1.0 - du[:, 0])
        assert du[hit_j].max() <= 1e-6, (kind, du[hit_j].max())
        assert (uv_t[~hit_t] == 0).all()
        if kind == TSH.CUBE:
            assert (uv_t == 0).all()
        plain = TSH.ray_intersect(ts_, torch.tensor(o), torch.tensor(d))
        assert len(plain) == 5 and all(
            torch.equal(a, b) for a, b in zip(plain, out[:3] + out[4:]))

    pos, idx = icosphere(2)
    uvs = rng.uniform(size=(len(pos), 2)).astype(np.float32)
    cols = rng.uniform(size=(len(pos), 3)).astype(np.float32)
    meshes = [dict(positions=pos, indices=idx, normals=pos.copy(), uvs=uvs,
                   colors=cols, to_world=t2w, bsdf_idx=0)]
    jm = JMESH.make_mesh_table(meshes)
    tm = TMESH.make_mesh_table(meshes, device="cpu")
    _, _, _, b1, b2, tri, hit = JMESH.mesh_intersect(jm, jnp.asarray(o),
                                                     jnp.asarray(d))
    hit = np.asarray(hit)
    assert hit.mean() > 0.2
    # the same hits on both sides: the interpolation alone
    b1_t, b2_t, tri_t = (torch.tensor(np.asarray(x)) for x in (b1, b2, tri))
    tri_t = tri_t.long()
    for fj, ft in ((JMESH.mesh_interp_uv, TMESH.mesh_interp_uv),
                   (JMESH.mesh_interp_color, TMESH.mesh_interp_color)):
        vj = np.asarray(fj(jm, tri, b1, b2))
        vt = ft(tm, tri_t, b1_t, b2_t).numpy()
        assert np.abs(vt - vj)[hit].max() <= 1e-6
