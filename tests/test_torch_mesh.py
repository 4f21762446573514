"""The port's triangle meshes (`tpusky_torch.render.mesh`, the K14
wrapper's tables and plain version, the mesh readers) against the JAX
package on the CPU.

The mesh tables are built on the host by the same numpy steps, so they
must equal JAX's bitwise, triangle order included, and triangle ids then
compare one to one. The plain closest hit is held against JAX's dense
scan, its ray-block culled path (more than 512 triangles, 8,192-ray
blocks) and its Pallas kernel in interpret mode (as tests/test_mesh.py
runs it), on a coherent and an incoherent wavefront.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusky.render import mesh as JMESH
from tpusky.render.scene import make_scene as jax_make_scene
from tpusky.utils import meshio as jax_meshio
from tpusky.utils.native import _load_obj_py

from tpusky_torch import convert
from tpusky_torch.ops.cuda import build
from tpusky_torch.ops.cuda import mesh_kernel as TK
from tpusky_torch.render import mesh as TMESH
from tpusky_torch.render.scene import make_scene
from tpusky_torch.utils import meshio
from tpusky_torch.utils.obj import load_obj

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)


def _meshes(rng, colors):
    """icosphere(3) under a rotation, scale and translation with a fifth of
    its vertex normals missing, and a quad with uvs and no normals."""
    pos, idx = meshio.icosphere(3)
    nrm = pos.copy()
    nrm[rng.random(len(nrm)) < 0.2] = 0.0
    a = 0.7
    t2w = np.eye(4, dtype=np.float32)
    t2w[:3, :3] = np.array([[np.cos(a), -np.sin(a), 0],
                            [np.sin(a), np.cos(a), 0], [0, 0, 1]]) * 1.5
    t2w[:3, 3] = [0.2, -0.3, 1.0]
    sphere = dict(positions=pos, indices=idx, normals=nrm, to_world=t2w,
                  bsdf_idx=1)
    if colors:
        sphere["colors"] = rng.random((len(pos), 3)).astype(np.float32)
    quad = dict(positions=np.array([[-2, -2, 0], [2, -2, 0], [2, 2, 0],
                                    [-2, 2, 0]], np.float32),
                indices=np.array([[0, 1, 2], [0, 2, 3]], np.int32),
                uvs=np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32),
                bsdf_idx=2)
    return [sphere, quad]


def _sphere_mesh(n_subdiv):
    pos, idx = meshio.icosphere(n_subdiv)
    return [dict(positions=pos, indices=idx, normals=pos.copy(), bsdf_idx=1)]


def _rays(kind, n, rng):
    """tools/bench_mesh.py:75-96's two wavefronts at n rays: coherent,
    raster-ordered from y = -4; incoherent, origins on the r = 1.3 sphere
    and random directions."""
    if kind == "coherent":
        side = int(np.sqrt(n))
        ys, xs = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
        u0 = (xs.ravel() + 0.5) / side * 2 - 1
        u1 = (ys.ravel() + 0.5) / side * 2 - 1
        o = np.stack([u0 * 2, np.full(side * side, -4.0), u1 * 2], -1)
        d = np.stack([-0.2 * u0, np.ones(side * side), -0.2 * u1], -1)
    else:
        d = rng.normal(size=(n, 3))
        o = 1.5 * rng.normal(size=(n, 3))
        o = o / np.linalg.norm(o, axis=-1, keepdims=True) * 1.3
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _port(jax_mesh):
    return convert.mesh_table(jax.tree.map(np.asarray, jax_mesh),
                              device="cpu")


@pytest.mark.parametrize("colors", [True, False])
def test_mesh_table_matches_jax_bitwise(colors):
    meshes = _meshes(np.random.default_rng(1), colors)
    ref = JMESH.make_mesh_table(meshes)
    out = TMESH.make_mesh_table(meshes, device="cpu")
    assert out.v0.shape == (1408, 3)          # 1,282 triangles padded
    for f in TMESH.MeshTable._fields:
        a, b = getattr(ref, f), getattr(out, f)
        if a is None:
            assert b is None and not colors, f
            continue
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f)
    assert out.bsdf_idx.dtype == torch.int64


def test_icosphere_is_bench_meshs():
    from tools.bench_mesh import icosphere
    for n in (0, 2):
        for a, b in zip(meshio.icosphere(n), icosphere(n)):
            np.testing.assert_array_equal(a, b)


# (triangles, rays): JAX's dense scan at 320; its culled path at 1,280 and
# 16,384 rays (two 8,192-ray blocks)
_CASES = [(2, 4096), (3, 16384)]


@jax.jit
def _jax_queries(mesh, o, d, maxt):
    """JAX's mesh_intersect and mesh_test, compiled once per case."""
    return JMESH.mesh_intersect(mesh, o, d), JMESH.mesh_test(mesh, o, d, maxt)


@pytest.mark.parametrize("kind", ["coherent", "incoherent"])
@pytest.mark.parametrize("n_subdiv,n", _CASES, ids=["dense", "culled"])
def test_mesh_intersect_and_test_match_jax(n_subdiv, n, kind):
    """Hits equal; where both hit, t within 1e-5 relative, b1 and b2 within
    1e-4, tri equal on >= 0.999 (tests/test_mesh.py:112); shading normals
    and materials at the hit; mesh_test equal."""
    rng = np.random.default_rng(n_subdiv)
    meshes = _sphere_mesh(n_subdiv)
    jm = JMESH.make_mesh_table(meshes)
    tm = TMESH.make_mesh_table(meshes, device="cpu")
    o, d = _rays(kind, n, rng)
    maxt = rng.uniform(0.0, 4.0, n).astype(np.float32)
    if n_subdiv == 3:
        assert JMESH._cull_enabled() and n % JMESH._RAY_BLOCK == 0
    ref, occ_ref = _jax_queries(jm, o, d, maxt)
    ref, occ_ref = [np.asarray(x) for x in ref], np.asarray(occ_ref)
    ot, dt = torch.tensor(o), torch.tensor(d)
    out = [x.numpy() for x in TMESH.mesh_intersect(tm, ot, dt)]
    occ = TMESH.mesh_test(tm, ot, dt, torch.tensor(maxt)).numpy()

    t_r, n_r, mat_r, b1_r, b2_r, tri_r, hit_r = ref
    t, nrm, mat, b1, b2, tri, hit = out
    np.testing.assert_array_equal(hit, hit_r)
    assert 0.15 < hit.mean() < 0.6
    m = hit
    np.testing.assert_allclose(t[m], t_r[m], rtol=1e-5)
    assert np.abs(b1[m] - b1_r[m]).max() <= 1e-4
    assert np.abs(b2[m] - b2_r[m]).max() <= 1e-4
    assert (tri[m] == tri_r[m]).mean() >= 0.999
    assert np.abs(nrm[m] - n_r[m]).max() <= 1e-4
    np.testing.assert_array_equal(mat[m], mat_r[m])
    assert np.isinf(t[~m]).all() and (tri[~m] == -1).all()
    np.testing.assert_array_equal(occ, occ_ref)
    assert 0.02 < occ.mean() < hit.mean()


@pytest.mark.parametrize("kind", ["coherent", "incoherent"])
def test_ray_sort_order_matches_jax(kind):
    """The permutation and its inverse bitwise, the coherence test alike;
    the sorted query gives the direct one's hits after the inverse
    permutation."""
    rng = np.random.default_rng(5)
    meshes = _sphere_mesh(3)
    jm = JMESH.make_mesh_table(meshes)
    tm = TMESH.make_mesh_table(meshes, device="cpu")
    o, d = _rays(kind, 4096, rng)
    if kind == "coherent":
        d[::2] = np.abs(d[::2])               # octant runs of length 1
    order_r, inv_r = (np.asarray(x) for x in jax.jit(JMESH._ray_sort_order)(
        jm, o, d))
    ot, dt = torch.tensor(o), torch.tensor(d)
    order, inv = TMESH._ray_sort_order(tm, ot, dt)
    np.testing.assert_array_equal(order.numpy(), order_r)
    np.testing.assert_array_equal(inv.numpy(), inv_r)
    # the key's mesh bounds as K14's tables carry them: the same order
    tables = TK.mesh_tables(tm)
    for a, b in zip(TMESH._ray_sort_order(
            tm, ot, dt, (tables.key_lo, tables.key_hi)), (order, inv)):
        assert torch.equal(a, b)
    coherent = bool(JMESH._wavefront_coherent(jnp.asarray(d)))
    assert TMESH._wavefront_coherent(dt) == coherent
    assert not coherent
    # half a raster row: one octant
    assert TMESH._wavefront_coherent(torch.tensor(_rays("coherent", 4096,
                                                        rng)[1][:32]))
    direct = TK.mesh_intersect_kernel(tm, ot, dt)
    sorted_ = TK.mesh_intersect_kernel(tm, ot[order], dt[order])
    for a, b in zip(direct, sorted_):
        assert torch.equal(a, b[inv])


@pytest.mark.parametrize("case", ["sphere", "quad"])
def test_plain_takes_the_lower_index_of_a_duplicated_tile(case):
    """The tie rule K14 must follow: a MeshTable built directly (so Morton
    order does not put copies side by side) whose tiles j hold bitwise
    copies of tiles i < j; on every ray whose hit ties with its copy, the
    plain closest hit returns the original's id. "sphere": icosphere(3)'s
    10 tiles, then the 10 again in a random order; "quad": a ground quad
    in tile 0 and its copy in tile 16, the case in which K14 enters the
    copy first and must still take the quad at the same t
    (`chip_smoke.py::mesh_tie_phase` runs both on the card)."""
    import chip_smoke
    rng = np.random.default_rng(9)
    if case == "sphere":
        mesh = chip_smoke._tie_mesh(TMESH.make_mesh_table(_sphere_mesh(3),
                                                          device="cpu"), rng)
        o, d = (torch.tensor(x) for x in _rays("incoherent", 2048, rng))
        n_orig, copies = mesh.v0.shape[0] // 2, mesh.v0.shape[0] // 2
    else:
        mesh, o, d = chip_smoke._flat_tie_case(rng, "cpu", 2048)
        n_orig, copies = 2, 16 * 128
    ids = torch.arange(mesh.v0.shape[0])
    orig = ids < n_orig
    copy = (ids >= copies) & (ids < copies + n_orig)
    rec = torch.cat([mesh.v0, mesh.e1, mesh.e2], 1)
    for a, b in zip(torch.unique(rec[orig], dim=0, return_counts=True),
                    torch.unique(rec[copy], dim=0, return_counts=True)):
        assert torch.equal(a, b)            # bitwise the same triangles
    t, b1, b2, tri = TMESH._closest_plain(mesh, o, d)
    # the copies alone (the originals made padding) hit at the same t
    t_c, b1_c, b2_c, tri_c = TMESH._closest_plain(
        mesh._replace(valid=mesh.valid & ~orig), o, d)
    tied = (tri >= 0) & orig[tri.clamp(min=0)]
    assert int(tied.sum()) > 300
    assert not copy[tri[tri >= 0]].any()
    assert copy[tri_c[tied]].all()
    for a, b in ((t, t_c), (b1, b1_c), (b2, b2_c)):
        assert torch.equal(a[tied], b[tied])
    # the wrapper's CPU path is the plain version
    out = TK.mesh_intersect_kernel(mesh, o, d)
    for a, b in zip(out[:3], (t, b1, b2)):
        assert torch.equal(a, b)
    assert torch.equal(out[3].long(), tri)


def test_render_builds_no_kernel_tables_on_the_cpu():
    """render_rows builds K14's tables once for all its queries on the
    card (`scene.with_mesh_tables`); on the CPU the plain version needs
    none and the scene passes through unchanged."""
    from tpusky_torch.render import scene as TS
    sc = make_scene(meshes=_sphere_mesh(1), device="cpu")
    before = TK.builds
    assert TS.with_mesh_tables(sc) is sc and sc.mesh_tables is None
    assert TS.with_mesh_tables(sc._replace(mesh=None)).mesh_tables is None
    assert TK.builds == before


def test_convert_scene_matches_make_scene():
    meshes = _meshes(np.random.default_rng(2), colors=False)
    ground = np.diag([10.0, 10.0, 1.0, 1.0]).astype(np.float32)
    shapes = [dict(kind=1, to_world=ground, bsdf_idx=0)]
    albedos = [[0.5, 0.5, 0.5], [0.3, 0.5, 0.7], [0.2, 0.2, 0.2]]
    sc_j = jax_make_scene(shapes=shapes, bsdf_albedos=albedos, meshes=meshes)
    sc_c = convert.scene(jax.tree.map(np.asarray, sc_j), device="cpu")
    sc_t = make_scene(shapes=shapes, bsdf_albedos=albedos, meshes=meshes,
                      device="cpu")
    assert sc_t.mesh is not None and sc_c.mesh.col is None
    for a, b in zip(sc_c.mesh, sc_t.mesh):
        assert (a is None and b is None) or torch.equal(a, b)
    assert make_scene(shapes=shapes, device="cpu").mesh is None


def test_wrapper_guards():
    """K14's input checks, which run before every launch on the card: no
    adjoint (a mesh tensor, o or d requiring grad raises
    NotImplementedError), rays (N, 3) contiguous float32 on the tables'
    device. On the CPU the wrapper runs the plain version and builds
    nothing; another device raises."""
    tm = TMESH.make_mesh_table(_sphere_mesh(1), device="cpu")
    tables = TK.mesh_tables(tm)
    o, d = (torch.tensor(x) for x in _rays("incoherent", 64,
                                            np.random.default_rng(0)))
    TK.check_inputs(tm, o, d, tables)
    grad_mesh = tm._replace(v0=tm.v0.clone().requires_grad_())
    for args in ((grad_mesh, o, d), (tm, o.clone().requires_grad_(), d),
                 (tm, o, d.clone().requires_grad_())):
        with pytest.raises(NotImplementedError):
            TK.check_inputs(*args, tables)
    for bad in (o[:, :2], o.double(), o.t().contiguous().t(), o[:32]):
        with pytest.raises(ValueError):
            TK.check_inputs(tm, bad, d, tables)
    with pytest.raises(ValueError):
        TK.check_inputs(tm, o, d, tables._replace(tris=tables.tris[1:]))
    with pytest.raises(ValueError):
        TK.mesh_intersect_kernel(tm, o.to("meta"), d.to("meta"))
    build.reset_launches()
    TK.mesh_intersect_kernel(tm, o, d)
    assert build.launches["mesh_intersect"] == 0
    assert build.library.cache_info().currsize == 0


_OBJ = ("v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\nv 2 2 1\n"
        "vt 0 0\nvt 1 0\nvt 0 1\nvt 1 1\n"
        "f 1/1 2/2 4/4 3/3\nf -1 -2 -4\nf 2//1 5//1 4//1\n")


def test_load_obj_matches_jax(tmp_path):
    path = tmp_path / "m.obj"
    path.write_text(_OBJ)
    out, ref = load_obj(str(path)), _load_obj_py(str(path))
    assert out[2].shape == (4, 3)
    for a, b in zip(out, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_meshio_matches_jax(tmp_path):
    """PLY (ascii with uvs, binary with normals and colours) and Mitsuba
    .serialized (written and read back) give JAX's arrays."""
    ascii_ply = tmp_path / "a.ply"
    ascii_ply.write_text(
        "ply\nformat ascii 1.0\nelement vertex 4\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property float u\nproperty float v\nelement face 1\n"
        "property list uchar int vertex_indices\nend_header\n"
        "0 0 0 0 0\n1 0 0 1 0\n1 1 0 1 1\n0 1 0 0 1\n4 0 1 2 3\n")
    rng = np.random.default_rng(4)
    vert = np.zeros(5, [("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                        ("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4"),
                        ("red", "u1"), ("green", "u1"), ("blue", "u1")])
    for name in ("x", "y", "z", "nx", "ny", "nz"):
        vert[name] = rng.normal(size=5)
    for name in ("red", "green", "blue"):
        vert[name] = rng.integers(0, 256, 5)
    faces = b"".join(np.array([3], "u1").tobytes()
                     + np.array(f, "<i4").tobytes()
                     for f in ([0, 1, 2], [1, 3, 4]))
    binary_ply = tmp_path / "b.ply"
    binary_ply.write_bytes(
        b"ply\nformat binary_little_endian 1.0\nelement vertex 5\n"
        + b"".join(b"property float %s\n" % c.encode()
                   for c in ("x", "y", "z", "nx", "ny", "nz"))
        + b"property uchar red\nproperty uchar green\nproperty uchar blue\n"
        b"element face 2\nproperty list uchar int vertex_indices\n"
        b"end_header\n" + vert.tobytes() + faces)
    for path in (ascii_ply, binary_ply):
        out, ref = meshio.read_ply(str(path)), jax_meshio.read_ply(str(path))
        for a, b in zip(out, ref):
            assert (a is None and b is None) or np.array_equal(a, b)
    pos, idx = meshio.icosphere(1)
    uv = rng.random((len(pos), 2)).astype(np.float32)
    ser = os.path.join(tmp_path, "m.serialized")
    meshio.write_serialized(ser, pos, idx, normals=pos, uvs=uv)
    ser_ref = os.path.join(tmp_path, "ref.serialized")
    jax_meshio.write_serialized(ser_ref, pos, idx, normals=pos, uvs=uv)
    with open(ser, "rb") as f, open(ser_ref, "rb") as g:
        assert f.read() == g.read()
    for face_normals in (False, True):
        out = meshio.read_serialized(ser, face_normals=face_normals)
        ref = jax_meshio.read_serialized(ser, face_normals=face_normals)
        for a, b in zip(out, ref):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(out[0], pos)
