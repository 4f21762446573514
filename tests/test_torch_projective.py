"""The port's projective boundary gradients (`tpusky_torch.ad.projective`)
against the JAX package's on the CPU, part 1: its random numbers
(`render.sampler.uniform` and `split`, bitwise `jax.random`'s), the film
projection, every shape kind's discontinuity curves and the mesh's edge
table; `primary_boundary_grad` with guiding; `shadow_boundary_grad`
(tests/test_projective.py's scenes at a 16x16 film, few samples). The
probes draw the reference's random streams, so the gradients agree to
float32 rounding. Each reference is one jitted program.

At most 3 items, so that pytest-xdist's `--dist loadfile` hands this
file out after tests/test_multihost.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import torch_projective_case as P
from tpusky.ad import projective as JP
from tpusky.render import mesh as JMe
from tpusky_torch import convert
from tpusky_torch.ad import projective as TP
from tpusky_torch.render import sampler as S
from tpusky_torch.utils.meshio import icosphere

torch.set_num_threads(1)


def test_random_numbers_curves_and_edges_match_jax():
    """`uniform` bitwise `jax.random.uniform` (1-D and 2-D shapes, several
    folded keys) and `split` `jax.random.split`; film_uv and each shape
    kind's curve, seen from one eye and from an eye per point, within
    1e-5 of the reference's scale; `_mesh_edges` of an icosphere's
    table (the edge order, endpoints, lengths and face normals) equal to
    the reference's."""
    for seed, tag, shape in ((0, 17, (5,)), (11, 1017, (300,)),
                             (3, 31337, (64, 2))):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), tag)
        words = np.asarray(jax.random.key_data(key))
        got = S.uniform(words, shape, "cpu").numpy()
        want = np.asarray(jax.random.uniform(key, shape))
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
        assert np.array_equal(np.stack(S.split(words, 3)), np.asarray(
            jax.random.key_data(jax.random.split(key, 3))))
    rng = np.random.default_rng(5)
    sensor = P.camera()
    t2w = np.eye(4, dtype=np.float32)
    t2w[:3, :3] = np.asarray([[0.9, 0.2, 0.0], [-0.1, 0.7, 0.3],
                              [0.0, 0.1, 1.1]], np.float32)
    t2w[:3, 3] = [0.3, -0.2, 1.0]
    eyes = (rng.normal(size=(40, 3)) * 3 + [0, -6, 2]).astype(np.float32)
    se_t = convert.sensor(sensor, device="cpu")
    ts = {kind: (rng.random(40) * t_len).astype(np.float32)
          for kind, (_, t_len) in JP._CURVES.items()}

    @jax.jit
    def ref(ts):
        out = {}
        for kind, (curve, _) in JP._CURVES.items():
            x = curve(jnp.asarray(t2w), sensor.to_world[:3, 3], ts[kind])
            per = jax.vmap(lambda e, tt, c=curve: c(jnp.asarray(t2w), e,
                                                    tt[None])[0])(
                jnp.asarray(eyes), ts[kind])
            out[kind] = (x, per) + JP.film_uv(sensor, x)
        return out
    want = ref(ts)
    for kind, (curve, _) in TP._CURVES.items():
        t = torch.as_tensor(ts[kind])
        x_t = curve(torch.as_tensor(t2w), se_t.to_world[:3, 3], t)
        per_t = curve(torch.as_tensor(t2w), torch.as_tensor(eyes), t)
        x_j, per_j, uv_j, ok_j = want[kind]
        P.check(x_t, x_j, 1e-5, f"curve {kind}")
        P.check(per_t, per_j, 1e-5, f"curve {kind}, an eye per point")
        uv_t, ok_t = TP.film_uv(se_t, x_t)
        P.check(uv_t, uv_j, 1e-5, f"film_uv {kind}")
        assert np.array_equal(ok_t.numpy(), np.asarray(ok_j))
    pos, idx = icosphere(2)
    jm = JMe.make_mesh_table([dict(positions=pos, indices=idx,
                                   to_world=np.eye(4, dtype=np.float32),
                                   bsdf_idx=0)])
    got = TP._mesh_edges(convert.mesh_table(jm, device="cpu"))
    want = JP._mesh_edges(jm)
    assert got[0].shape == (480, 3)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_primary_boundary_grad_matches_jax():
    """primary_boundary_grad of the sphere over the ground under the sky
    (the FD test's camera), guided (8 bins: the seed pass, the histogram
    and the guided main pass), 64 samples, 2 probe paths of depth 1 (the
    sky seen past the silhouette; depth 2 is the shadow test's): d
    to_world of the sphere within 1e-4 of the reference's scale, the
    ground's row zero (not asked for), no mesh term."""
    scene = P.sphere_on_ground(P.sky_env())
    sensor = P.camera()
    gi = P.grad_image()
    key = jax.random.PRNGKey(11)
    kw = dict(n_samples=64, probe_spp=2, max_depth=1, shape_indices=[1],
              guide_bins=8)
    want = jax.jit(lambda g: JP.primary_boundary_grad(
        scene, sensor, P.jfilm(), g, key, **kw)[0])(jnp.asarray(gi))
    got, d_mesh = TP.primary_boundary_grad(*P.port(scene, sensor, gi, key),
                                           **kw)
    assert d_mesh is None and float(got[0].abs().max()) == 0.0
    P.check(got, want, 1e-4, "primary_boundary_grad")


def test_shadow_boundary_grad_matches_jax():
    """shadow_boundary_grad of the sphere's shadow under the delta
    directional light on the ground (the shadow test's scene and camera,
    no environment), 64 samples, 2 probe paths, unguided: d to_world of
    the blocker within 1e-4 of the reference's scale."""
    scene = P.sphere_on_ground(directional=True)
    sensor = P.camera("shadow")
    gi = P.grad_image(1)
    key = jax.random.PRNGKey(22)
    kw = dict(blocker_indices=[1], n_samples=64, probe_spp=2, max_depth=2)
    want = jax.jit(lambda g: JP.shadow_boundary_grad(
        scene, sensor, P.jfilm(), g, key, P.LD, **kw))(jnp.asarray(gi))
    got = TP.shadow_boundary_grad(*P.port(scene, sensor, gi, key), P.LD,
                                  **kw)
    P.check(got, want, 1e-4, "shadow_boundary_grad")
