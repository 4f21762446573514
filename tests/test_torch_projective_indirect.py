"""The port's projective boundary gradients against the JAX package's on
the CPU, part 2: `indirect_boundary_grad` through a one-bounce BSDF walk,
the mesh blocker's terms (`indirect_boundary_grad_mesh` and
`primary_boundary_grad`'s mesh translation) and `boundary_grad`'s
composition with a directional light and the indirect term
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
from tpusky_torch.ad import projective as TP

torch.set_num_threads(1)


def test_indirect_boundary_grad_matches_jax():
    """indirect_boundary_grad of the sphere between the area panel and
    the ground, the receivers at the end of a one-bounce detached BSDF
    walk from the camera (prefix_depth 1), 512 receivers, 2 probe paths
    of depth 1 (the panel seen past the blocker): the blocker's
    translation gradient within 1e-4 of the reference's scale."""
    scene = P.panel_scene("sphere")
    sensor = P.camera("panel")
    gi = P.grad_image(2)
    key = jax.random.PRNGKey(11)
    kw = dict(blocker_indices=[1], n_x=512, probe_spp=2, max_depth=2,
              prefix_depth=1)
    want = jax.jit(lambda g: JP.indirect_boundary_grad(
        scene, sensor, P.jfilm(), g, key, **kw))(jnp.asarray(gi))
    got = TP.indirect_boundary_grad(*P.port(scene, sensor, gi, key), **kw)
    P.check(got, want, 1e-4, "indirect_boundary_grad")


def test_mesh_boundary_grads_match_jax(monkeypatch):
    """The icosphere(1) blocker under the panel: its edges' indirect term
    (indirect_boundary_grad_mesh, 512 receivers, 2 probe paths of depth
    1); and the icosphere alone under the sky, its silhouette's primary
    term (primary_boundary_grad's mesh translation, 64 samples, 2 probe
    paths of depth 1: the sky past the silhouette); each within 1e-4 of
    the reference's scale. The reference samples the primary term on
    every edge, where its two-sided probes read a jump of O(delta)
    across each edge of continuous shading and bias the term (R26); the
    port samples the edges on the silhouette from the eye, so its term
    is held against the reference's estimator on those edges. The
    reference's mesh terms read the total edge length as a Python float:
    its edge table, built outside the program, hands the lengths over as
    numpy, so that each term compiles as one program."""
    edges = JP._mesh_edges

    def table(mesh, eye=None):
        e0, e1, lens, n_a, n_b = edges(mesh)
        if eye is not None:
            to_eye = np.asarray(e0) - eye
            keep = ((np.asarray(n_a) * to_eye).sum(-1)
                    * (np.asarray(n_b) * to_eye).sum(-1)) < 0.0
            e0, e1, lens, n_a, n_b = (jnp.asarray(np.asarray(x)[keep])
                                      for x in (e0, e1, lens, n_a, n_b))
        return e0, e1, np.asarray(lens), n_a, n_b
    for sc in (P.panel_scene("mesh"), P.mesh_under_sky()):
        edges(sc.mesh)
    monkeypatch.setattr(JP, "_mesh_edges", table)
    scene = P.panel_scene("mesh")
    sensor = P.camera("panel")
    gi = P.grad_image(3)
    key = jax.random.PRNGKey(7)
    kw_i = dict(n_x=512, probe_spp=2, max_depth=2)
    want_i = jax.jit(lambda g: JP.indirect_boundary_grad_mesh(
        scene, sensor, P.jfilm(), g, key, **kw_i))(jnp.asarray(gi))
    P.check(TP.indirect_boundary_grad_mesh(
        *P.port(scene, sensor, gi, key), **kw_i), want_i, 1e-4,
        "indirect_boundary_grad_mesh")
    scene = P.mesh_under_sky()
    sensor = P.camera()
    silhouette = table(scene.mesh, np.asarray(sensor.to_world[:3, 3]))
    assert 0 < silhouette[0].shape[0] < edges(scene.mesh)[0].shape[0]
    monkeypatch.setattr(JP, "_mesh_edges", lambda mesh: silhouette)
    kw_p = dict(n_samples=64, probe_spp=2, max_depth=1)
    want_p = jax.jit(lambda g: JP.primary_boundary_grad(
        scene, sensor, P.jfilm(), g, key, **kw_p)[1])(jnp.asarray(gi))
    P.check(TP.primary_boundary_grad(*P.port(scene, sensor, gi, key),
                                     **kw_p)[1], want_p, 1e-4,
            "primary_boundary_grad's mesh term")


def test_boundary_grad_matches_jax():
    """boundary_grad of the sphere over the ground under the delta
    directional light, composing the shadow and the indirect terms
    (light_dir, indirect=True; the primary term, tested above, left out
    by shape_indices=[]), 64 samples, 2 probe paths of depth 2,
    unguided: d to_world of the sphere within 1e-4 of the reference's
    scale, its translation column carrying the indirect term; no mesh
    term."""
    scene = P.sphere_on_ground(directional=True)
    sensor = P.camera("shadow")
    gi = P.grad_image(4)
    key = jax.random.PRNGKey(5)
    kw = dict(light_dir=P.LD, indirect=True, shape_indices=[],
              blocker_indices=[1], n_samples=64, probe_spp=2, max_depth=2)
    want = jax.jit(lambda g: JP.boundary_grad(
        scene, sensor, P.jfilm(), g, key, **kw)[0])(jnp.asarray(gi))
    got, d_mesh = TP.boundary_grad(*P.port(scene, sensor, gi, key), **kw)
    assert d_mesh is None
    P.check(got, want, 1e-4, "boundary_grad")
