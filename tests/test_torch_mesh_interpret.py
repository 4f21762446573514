"""K14's plain version and tables against the JAX package's mesh kernel
in interpret mode (as tests/test_mesh.py runs it), on the CPU.

Its own file (of one test) because the interpret-mode kernel's compile
is most of its time: pytest-xdist's `--dist loadfile` hands out small
files last, so this one runs beside tests/test_multihost.py and adds
nothing to the wall of a run.
"""

import jax
import numpy as np
import torch

from tpusky.ops.pallas import mesh_kernel as PMK
from tpusky.ops.pallas.mesh_kernel import (mesh_intersect_pallas,
                                           mesh_tables_pallas)
from tpusky.render import mesh as JMESH

from tpusky_torch import convert
from tpusky_torch.ops.cuda import mesh_kernel as TK

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)


def _port(jax_mesh):
    return convert.mesh_table(jax.tree.map(np.asarray, jax_mesh),
                              device="cpu")


def test_plain_matches_pallas_kernel_in_interpret_mode(monkeypatch):
    """As tests/test_mesh.py:87-110: 700 small random triangles, 4,096 rays,
    the Pallas kernel in interpret mode; hits equal, t within rtol 1e-4 /
    atol 1e-5, tri equal on >= 0.999. The K14 wrapper's tables hold the
    reference kernel's tile and supertile bounds exactly.

    The interpret-mode program is compiled with XLA:CPU's fusion emitters
    off: the same kernel, its hits, t and ids bitwise the default
    compile's, in ~17 s of compile where the default takes ~40 s."""
    isect = PMK._mesh_isect_pallas

    def isect_quick_compile(n_tiles, *args, interpret=False):
        return isect.lower(n_tiles, *args, interpret=interpret).compile(
            {"xla_cpu_use_fusion_emitters": False})(*args)
    monkeypatch.setattr(PMK, "_mesh_isect_pallas", isect_quick_compile)
    rng = np.random.default_rng(3)
    n_tri = 700
    v = rng.uniform(-1, 1, (n_tri, 3, 3)).astype(np.float32)
    v[:, 1:] = v[:, :1] + 0.2 * (v[:, 1:] - v[:, :1])
    pos = v.reshape(-1, 3)
    idx = np.arange(3 * n_tri, dtype=np.int32).reshape(-1, 3)
    meshes = [dict(positions=pos, indices=idx, normals=np.zeros_like(pos),
                   bsdf_idx=0)]
    jm = JMESH.make_mesh_table(meshes)
    n = 4096
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = (rng.normal(size=(n, 3)) * 0.5 - [0, 3, 0]).astype(np.float32)
    t_p, b1_p, b2_p, tri_p, hit_p = (np.asarray(x) for x in
                                     mesh_intersect_pallas(jm, o, d,
                                                           interpret=True))
    tm = _port(jm)
    t, b1, b2, tri, hit = (x.numpy() for x in TK.mesh_intersect_kernel(
        tm, torch.tensor(o), torch.tensor(d)))
    assert tri.dtype == np.int32
    np.testing.assert_array_equal(hit, hit_p)
    assert hit.mean() > 0.02
    np.testing.assert_allclose(t[hit], t_p[hit], rtol=1e-4, atol=1e-5)
    assert (tri[hit] == tri_p[hit]).mean() >= 0.999

    # K14's triangle records hold the reference's planes: record k of tile
    # j is [v0.xyz, e1.xyz, e2.xyz, 0, 0, 0] = planes[:, j, k], then zeros
    tv_p, lo_p, hi_p, slo_p, shi_p = (np.asarray(x)
                                      for x in mesh_tables_pallas(jm))
    tables = TK.mesh_tables(tm)
    assert tables.tris.shape == (16, 128, 12)   # 6 tiles padded to 16
    np.testing.assert_array_equal(
        tables.tris[..., :9].numpy(), tv_p.transpose(1, 2, 0))
    assert not tables.tris[..., 9:].any()
    for box, lo, hi in ((tables.boxes, lo_p, hi_p),
                        (tables.super_boxes, slo_p, shi_p)):
        np.testing.assert_array_equal(box[:, :3].numpy(), lo[:, :3])
        np.testing.assert_array_equal(box[:, 4:7].numpy(), hi[:, :3])
        assert not box[:, 3].any() and not box[:, 7].any()
    # K14's own leaf boxes (32 triangles each) hold their valid triangles'
    # corners, and those with any make up their tile's box exactly;
    # all-padding leaves and padding tiles' leaves are never entered
    # (lo > hi)
    leaves = tables.leaves.reshape(16, 4, 8)
    full = (leaves[..., 0] <= leaves[..., 4])[..., None]
    assert torch.equal(torch.where(full, leaves[..., :3], torch.inf)
                       .amin(1)[:6], tables.boxes[:6, :3])
    assert torch.equal(torch.where(full, leaves[..., 4:7], -torch.inf)
                       .amax(1)[:6], tables.boxes[:6, 4:7])
    corners = torch.stack([tm.v0, tm.v0 + tm.e1, tm.v0 + tm.e2], 1)
    n_leaves = tm.v0.shape[0] // 32
    lo, hi = tables.leaves[:n_leaves, None, None, :3], \
        tables.leaves[:n_leaves, None, None, 4:7]
    inside = ((corners.reshape(n_leaves, 32, 3, 3) >= lo)
              & (corners.reshape(n_leaves, 32, 3, 3) <= hi)).all(-1).all(-1)
    assert inside[tm.valid.reshape(n_leaves, 32)].all()
    empty = ~tm.valid.reshape(n_leaves, 32).any(1)
    assert empty.any() and (tables.leaves[:n_leaves][empty, 0]
                            > tables.leaves[:n_leaves][empty, 4]).all()
    assert (tables.leaves[n_leaves:, 0] > tables.leaves[n_leaves:, 4]).all()
