"""The port's LargeSteps (`tpusky_torch.ad.largesteps`) against the JAX
package's on the CPU: the unique-edge list exactly, (I + λL) v, the
conjugate-gradient round trip and the gradient through
`from_differential` against `jax.grad`, on tests/test_ad.py's octahedron
and on icospheres.

At most 3 items, so that pytest-xdist's `--dist loadfile` hands this
file out after tests/test_multihost.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tpusky.ad import largesteps as JLS
from tpusky_torch.ad import largesteps as TLS
from tpusky_torch.utils.meshio import icosphere

torch.set_num_threads(1)


def _octahedron():
    v = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0],
                  [0, -1, 0], [0, 0, 1], [0, 0, -1]], np.float32)
    f = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
                  [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]], np.int32)
    return v, f


def _meshes():
    return {"octahedron": _octahedron(), "icosphere(2)": icosphere(2),
            "icosphere(4)": icosphere(4)}


def test_laplacian_edges_and_matrix_match_jax():
    """mesh_laplacian_edges equal to the reference's, element for element
    (12 edges on the octahedron, 3 V - 6 on an icosphere); to_differential
    (I + λL) v within 1e-6 of the reference's scale."""
    for name, (v, f) in _meshes().items():
        e = TLS.mesh_laplacian_edges(f)
        ref = JLS.mesh_laplacian_edges(f)
        assert e.dtype == ref.dtype and np.array_equal(e, ref), name
        assert e.shape[0] == 3 * v.shape[0] - 6, name
        u = TLS.LargeSteps(v, f, lambda_=19.0, device="cpu"
                           ).to_differential(v).numpy()
        u_ref = np.asarray(JLS.LargeSteps(v, f, lambda_=19.0)
                           .to_differential(v))
        assert np.abs(u - u_ref).max() <= 1e-6 * np.abs(u_ref).max(), name


def test_round_trip_matches_jax():
    """from_differential(to_differential(v)) gives v back within 1e-4
    (tests/test_ad.py:177-182's bar) and the reference's solve within
    1e-5 of its scale, in a CG of at most the reference's 200 steps."""
    for name, (v, f) in _meshes().items():
        ls = TLS.LargeSteps(v, f, lambda_=19.0, device="cpu")
        v2 = ls.from_differential(ls.to_differential(v)).numpy()
        assert 0 < ls.last_iterations <= 200, name
        np.testing.assert_allclose(v2, v, atol=1e-4, err_msg=name)
        jls = JLS.LargeSteps(v, f, lambda_=19.0)
        ref = np.asarray(jls.from_differential(jls.to_differential(v)))
        assert np.abs(v2 - ref).max() <= 1e-5 * np.abs(ref).max(), name


def test_gradient_through_solve_matches_jax():
    """The gradient of a loss of from_differential(u) to u, against
    jax.grad through `jax.scipy.sparse.linalg.cg` (its implicit
    transpose), within 1e-4 of its scale; a single vertex's gradient
    moves its neighbours (tests/test_ad.py:203-220)."""
    v, f = icosphere(2)
    rng = np.random.default_rng(3)
    w = rng.normal(size=v.shape).astype(np.float32)
    jls = JLS.LargeSteps(v, f, lambda_=19.0)
    u = np.asarray(jls.to_differential(v))
    g_ref = np.asarray(jax.grad(lambda u_: jnp.sum(
        jnp.sin(jls.from_differential(u_)) * w))(jnp.asarray(u)))
    ls = TLS.LargeSteps(v, f, lambda_=19.0, device="cpu")
    ut = torch.tensor(u, requires_grad=True)
    (torch.sin(ls.from_differential(ut)) * torch.as_tensor(w)).sum(
    ).backward()
    g = ut.grad.numpy()
    assert np.abs(g - g_ref).max() <= 1e-4 * np.abs(g_ref).max()
    ut = torch.tensor(u, requires_grad=True)
    ls.from_differential(ut)[4, 2].backward()
    moved = ut.grad.abs().sum(-1)
    e = TLS.mesh_laplacian_edges(f)
    neigh = np.unique(np.concatenate([e[e[:, 0] == 4, 1], e[e[:, 1] == 4, 0]]))
    assert float(moved[4]) > 0 and bool((moved[neigh] > 1e-6).all())
