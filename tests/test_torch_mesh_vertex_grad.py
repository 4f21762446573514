"""Mesh vertex gradients on the CPU: the attached Moller-Trumbore hit
(`render/mesh.py::_attached_hit`, which on the card differentiates the
hit at the triangle K14 picks) against the plain path's own gradients,
against `jax.grad` of the JAX package's `mesh_intersect` and against
central differences on rays that stay inside their triangles (the
reference never checks its vertex gradients, R6); and a tiny mesh
render's gradient to a translation of the mesh and to its v0, e1, e2
against `jax.grad` of the reference's `render`.

At most 3 items, so that pytest-xdist's `--dist loadfile` hands this
file out after tests/test_multihost.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import tpusky as ts
from tpusky.render import integrator as JI
from tpusky.render import mesh as JMe
from tpusky.render.film import Film as JFilm
from tpusky.render.scene import make_scene as j_make_scene
from tpusky.render.sensors import make_perspective as j_perspective
from tpusky_torch import convert
from tpusky_torch.render import integrator as TI
from tpusky_torch.render import mesh as TMe
from tpusky_torch.render.film import Film
from tpusky_torch.render.loader import prng_key
from tpusky_torch.utils.meshio import icosphere

torch.set_num_threads(1)


def _mesh_and_rays(n=3000, subdiv=2, seed=0):
    """icosphere(subdiv) at the origin as JAX's and the port's tables, and
    n rays from one eye toward random points about it, with weights."""
    pos, idx = icosphere(subdiv)
    jm = JMe.make_mesh_table([dict(positions=pos, indices=idx,
                                   to_world=np.eye(4, dtype=np.float32),
                                   bsdf_idx=0)])
    rng = np.random.default_rng(seed)
    o = np.broadcast_to(np.float32([0.2, -4.0, 0.3]), (n, 3)).copy()
    d = (rng.random((n, 3)) * 2.4 - 1.2).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    w = rng.normal(size=(n, 3)).astype(np.float32)
    return jm, convert.mesh_table(jm, device="cpu"), o, d, w


def _loss(t, b1, b2, w, lib):
    """A weighted sum of t (hits only), b1 and b2."""
    t = lib.where(lib.isfinite(t), t, 0.0)
    return (t * w[:, 0] + b1 * w[:, 1] + b2 * w[:, 2]).sum()


def _leaves(mesh, dtype=torch.float32):
    return [getattr(mesh, k).to(dtype).clone().requires_grad_()
            for k in ("v0", "e1", "e2")]


def test_attached_hit_matches_plain_and_jax():
    """At the plain path's triangles (picked under no_grad, as K14 picks
    them on the card): t, b1 and b2 bitwise the plain path's, finite at
    the misses (t = inf, b1 = b2 = 0), and the gradients of a weighted
    loss to v0, e1, e2 within 1e-5 of the plain path's scale and 1e-4 of
    jax.grad's of the reference's mesh_intersect."""
    jm, tm, o, d, w = _mesh_and_rays()
    o_t, d_t, w_t = (torch.as_tensor(x) for x in (o, d, w))
    with torch.no_grad():
        tri = TMe._closest_plain(tm, o_t, d_t)[3]
    assert 0 < int((tri >= 0).sum()) < tri.shape[0]
    leaves = _leaves(tm)
    mt = tm._replace(v0=leaves[0], e1=leaves[1], e2=leaves[2])
    plain = TMe._closest_plain(mt, o_t, d_t)[:3]
    g_plain = torch.autograd.grad(_loss(*plain, w_t, torch), leaves)
    hit = TMe._attached_hit(mt, o_t, d_t, tri)
    for a, b in zip(hit, plain):
        assert torch.equal(a, b)
    g = torch.autograd.grad(_loss(*hit, w_t, torch), leaves)

    def j_loss(v0, e1, e2):
        m = jm._replace(v0=v0, e1=e1, e2=e2)
        t, _n, _m, b1, b2, _tri, _hit = JMe.mesh_intersect(
            m, jnp.asarray(o), jnp.asarray(d))
        return _loss(t, b1, b2, jnp.asarray(w), jnp)
    g_ref = jax.grad(j_loss, argnums=(0, 1, 2))(jm.v0, jm.e1, jm.e2)
    for name, a, b, c in zip(("v0", "e1", "e2"), g, g_plain, g_ref):
        assert bool(torch.isfinite(a).all()), name
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-5 * scale, name
        c = np.asarray(c)
        assert np.abs(a.numpy() - c).max() <= 1e-4 * np.abs(c).max(), name


def test_attached_hit_matches_central_differences():
    """In float64, on the rays whose hit lies inside its triangle (b1,
    b2 >= 0.05, b1 + b2 <= 0.95) so that no step moves a ray off it: the
    derivative of the weighted loss to a shift of every v0, e1 or e2
    component, against the central difference of step 1e-6, within
    1e-6 relative (floor 1e-6)."""
    _, tm, o, d, w = _mesh_and_rays(seed=1)
    o_t, d_t = torch.as_tensor(o, dtype=torch.float64), \
        torch.as_tensor(d, dtype=torch.float64)
    with torch.no_grad():
        tri = TMe._closest_plain(tm, torch.as_tensor(o), torch.as_tensor(d)
                                 )[3]
        _, b1, b2 = TMe._attached_hit(tm, torch.as_tensor(o),
                                      torch.as_tensor(d), tri)
    inside = (tri >= 0) & (b1 >= 0.05) & (b2 >= 0.05) & (b1 + b2 <= 0.95)
    assert int(inside.sum()) > 500
    keep = inside.nonzero()[:, 0]
    o_t, d_t, tri = o_t[keep], d_t[keep], tri[keep]
    w_t = torch.as_tensor(w, dtype=torch.float64)[keep]
    leaves = _leaves(tm, torch.float64)
    mt = tm._replace(v0=leaves[0], e1=leaves[1], e2=leaves[2])
    grads = torch.autograd.grad(
        _loss(*TMe._attached_hit(mt, o_t, d_t, tri), w_t, torch), leaves)
    h = 1e-6
    for i, name in enumerate(("v0", "e1", "e2")):
        for k in range(3):
            vals = []
            for sgn in (1.0, -1.0):
                shifted = [x.detach().clone() for x in leaves]
                shifted[i][:, k] += sgn * h
                m = tm._replace(v0=shifted[0], e1=shifted[1], e2=shifted[2])
                vals.append(float(_loss(*TMe._attached_hit(m, o_t, d_t, tri),
                                        w_t, torch)))
            fd = (vals[0] - vals[1]) / (2 * h)
            ad = float(grads[i][:, k].sum())
            assert abs(ad - fd) <= 1e-6 * max(abs(fd), 1e-6) + 1e-6, \
                (name, k, ad, fd)


def test_mesh_render_gradient_matches_jax():
    """d mean(w * img) of an icosphere(1) on a ground under the sunsky
    (12x12x2, depth 2, the plain path) to a translation c of the mesh
    (v0 + c) and to its v0, e1, e2, against jax.grad of the reference's
    `render` at the same key: within 1e-3 of each gradient's scale."""
    pos, idx = icosphere(1)
    t2w = np.eye(4, dtype=np.float32)
    t2w[2, 3] = 1.0
    env = ts.sunsky_precompute(ts.make_params(
        turbidity=3.0, albedo=0.3, sun_direction=[0.3, 0.2, 0.93]))
    sc_j = j_make_scene(
        shapes=[dict(kind=1, to_world=np.diag([10.0, 10.0, 1.0, 1.0])
                     .astype(np.float32), bsdf_idx=0)],
        bsdf_albedos=[[0.5, 0.5, 0.5], [0.3, 0.5, 0.7]],
        meshes=[dict(positions=pos, indices=idx, normals=pos.copy(),
                     to_world=t2w, bsdf_idx=1)], env=env)
    se_j = j_perspective([3.5, -3.5, 2.0], [0, 0, 1.0], fov_x_deg=45)
    key = jax.random.PRNGKey(3)
    h = w_px = 12
    wgt = np.random.default_rng(4).random((h, w_px, 3)).astype(np.float32)

    @jax.jit
    def ref(c, v0, e1, e2):
        def loss(c, v0, e1, e2):
            m = sc_j.mesh._replace(v0=v0 + c, e1=e1, e2=e2)
            img = JI.render(sc_j._replace(mesh=m), se_j, JFilm(h, w_px, 3),
                            key, 2, max_depth=2)
            return jnp.mean(img * wgt)
        return jax.grad(loss, argnums=(0, 1, 2, 3))(c, v0, e1, e2)
    m = sc_j.mesh
    g_ref = [np.asarray(g) for g in ref(jnp.zeros(3), m.v0, m.e1, m.e2)]
    sc_t = convert.scene(sc_j, device="cpu")
    se_t = convert.sensor(se_j, device="cpu")
    c = torch.zeros(3, requires_grad=True)
    leaves = _leaves(sc_t.mesh)
    mt = sc_t.mesh._replace(v0=leaves[0] + c, e1=leaves[1], e2=leaves[2])
    img = TI.render(sc_t._replace(mesh=mt), se_t, Film(h, w_px, 3),
                    prng_key(3), spp=2, max_depth=2)
    g = torch.autograd.grad((img * torch.as_tensor(wgt)).mean(),
                            [c] + leaves)
    for name, a, b in zip(("c", "v0", "e1", "e2"), g, g_ref):
        assert bool(torch.isfinite(a).all()) and np.abs(b).max() > 0, name
        err = np.abs(a.numpy() - b).max() / np.abs(b).max()
        assert err <= 1e-3, (name, err)
