"""Triangle meshes: SoA tables and tiled Moller-Trumbore intersection.

The PyTorch counterpart of `tpusky/render/mesh.py`. Triangles of every
mesh are baked into world space on the host, Morton-ordered by centroid
so that each 128-triangle tile is spatially compact, and padded to a tile
multiple (`make_mesh_table`, numpy, bitwise the reference's tables).

`mesh_intersect` / `mesh_test` dispatch by device:

* a CPU tensor, or `plain=True`, runs the plain version: every ray
  against every tile, the per-tile closest hit by argmin, tiles merged in
  order with a strict `<` (`_tile_hits` and the scan of the reference's
  dense path, `tpusky/render/mesh.py:141-166, 419-437`), so the lowest
  triangle index wins a tie; a tile's test is skipped for the rays whose
  line passes outside its padded bounding sphere (`_near_tile`), which
  no ray of a hit in it does, so the results are the dense scan's;
* a CUDA tensor runs kernel K14 (`ops/cuda/mesh_kernel.py`), after the
  reference's ray-sort rule (`tpusky/render/mesh.py:388-413`): the
  wavefront is reordered by direction octant and origin Morton code unless
  the mesh is small and the wavefront already coherent. Where the
  triangles or the rays carry a gradient (reverse or forward mode), K14
  runs on detached copies and only picks each ray's triangle;
  `_attached_hit` then recomputes t, b1 and b2 at that triangle with the
  plain version's roundings, differentiably (the TPU kernel has no
  adjoint either).

`mesh_interp_uv` and `mesh_interp_color` interpolate the per-corner uv
and vertex colours at a hit, for textured scenes (`render/texture.py`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

_TILE = 128
_RAY_EPS = 1e-4
# rays per step of the plain version, which bounds its (rays, 128)
# temporaries: cache-sized on the CPU, fewer launches on the card
_PLAIN_RAYS = {"cpu": 1 << 12, "cuda": 1 << 16}
# Above this triangle count the reference sorts every wavefront; below it
# only the incoherent ones (`tpusky/render/mesh.py:345-350`)
_ADAPTIVE_SORT_MAX_TRIS = 32768


class MeshTable(NamedTuple):
    """All scene triangles, concatenated and padded to a tile multiple."""
    v0: torch.Tensor         # (T, 3)
    e1: torch.Tensor         # (T, 3) v1 - v0
    e2: torch.Tensor         # (T, 3) v2 - v0
    n0: torch.Tensor         # (T, 3) vertex normals for shading (v0)
    n1: torch.Tensor         # (T, 3)
    n2: torch.Tensor         # (T, 3)
    bsdf_idx: torch.Tensor   # (T,) int64
    valid: torch.Tensor      # (T,) bool (False on padding)
    uv: torch.Tensor         # (T, 3, 2) per-corner texture coordinates
    col: Optional[torch.Tensor] = None  # (T, 3, 3) per-corner vertex
    #                                     colours, None when no mesh has any


def make_mesh_table(meshes, device="cuda") -> MeshTable:
    """meshes: list of dicts {positions (V,3), indices (T,3), normals (V,3)
    optional, uvs (V,2) optional, colors (V,3) optional, to_world (4,4)
    optional, bsdf_idx int}. The host build of the reference
    (`tpusky/render/mesh.py:42-118`), step for step."""
    v0s, e1s, e2s, n0s, n1s, n2s, mats, uvs = [], [], [], [], [], [], [], []
    cols, any_cols = [], False
    for m in meshes:
        pos = np.asarray(m["positions"], np.float32)
        idx = np.asarray(m["indices"], np.int32)
        t2w = np.asarray(m.get("to_world", np.eye(4)), np.float32)
        pos_w = pos @ t2w[:3, :3].T + t2w[:3, 3]
        nrm = np.asarray(m.get("normals", np.zeros_like(pos)), np.float32)
        inv_t = np.linalg.inv(t2w[:3, :3]).T
        nrm_w = nrm @ inv_t.T
        tri = pos_w[idx]                      # (T, 3, 3)
        tn = nrm_w[idx]
        # faces without vertex normals fall back to the geometric normal
        geo_n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
        geo_n /= np.maximum(np.linalg.norm(geo_n, axis=-1, keepdims=True),
                            1e-12)
        missing = np.linalg.norm(tn, axis=-1) < 1e-6   # (T, 3)
        for c in range(3):
            tn[:, c][missing[:, c]] = geo_n[missing[:, c]]
        v0s.append(tri[:, 0])
        e1s.append(tri[:, 1] - tri[:, 0])
        e2s.append(tri[:, 2] - tri[:, 0])
        n0s.append(tn[:, 0])
        n1s.append(tn[:, 1])
        n2s.append(tn[:, 2])
        mats.append(np.full((len(idx),), m.get("bsdf_idx", 0), np.int64))
        uv_v = m.get("uvs")
        uv_v = (np.zeros((len(pos), 2), np.float32) if uv_v is None
                else np.asarray(uv_v, np.float32))
        uvs.append(uv_v[idx])                 # (T, 3, 2)
        col_v = m.get("colors")
        if col_v is not None:
            any_cols = True
            cols.append(np.asarray(col_v, np.float32)[idx])
        else:
            cols.append(np.zeros((len(idx), 3, 3), np.float32))

    def cat(parts, shape, dtype=np.float32):
        return np.concatenate(parts) if parts else np.zeros(shape, dtype)

    v0, e1, e2 = cat(v0s, (0, 3)), cat(e1s, (0, 3)), cat(e2s, (0, 3))
    n0, n1, n2 = cat(n0s, (0, 3)), cat(n1s, (0, 3)), cat(n2s, (0, 3))
    mat = cat(mats, (0,), np.int64)
    uv, col = cat(uvs, (0, 3, 2)), cat(cols, (0, 3, 3))

    # Morton order by centroid: each 128-triangle tile spatially compact,
    # so tile bounds are tight enough to cull (the sort replaces a BVH)
    if len(v0) > _TILE:
        order = _morton_order(v0 + (e1 + e2) / 3.0)
        v0, e1, e2 = v0[order], e1[order], e2[order]
        n0, n1, n2 = n0[order], n1[order], n2[order]
        mat, uv, col = mat[order], uv[order], col[order]

    t = len(v0)
    pad = (-t) % _TILE

    def padded(a):
        return torch.tensor(np.concatenate(
            [a, np.zeros((pad,) + a.shape[1:], a.dtype)]), device=device)

    valid = np.concatenate([np.ones((t,), bool), np.zeros((pad,), bool)])
    return MeshTable(padded(v0), padded(e1), padded(e2), padded(n0),
                     padded(n1), padded(n2), padded(mat),
                     torch.tensor(valid, device=device), padded(uv),
                     padded(col) if any_cols else None)


def _morton_order(c):
    """Argsort by 30-bit Morton code of points quantised to 1024^3 over
    their bounds (host-side numpy, build time only)."""
    lo = c.min(axis=0)
    ext = np.maximum(c.max(axis=0) - lo, 1e-12)
    q = np.clip(((c - lo) / ext * 1023.0).astype(np.uint32), 0, 1023)

    def spread(x):
        x = x.astype(np.uint64)
        x = (x | (x << 16)) & np.uint64(0x030000FF)
        x = (x | (x << 8)) & np.uint64(0x0300F00F)
        x = (x | (x << 4)) & np.uint64(0x030C30C3)
        x = (x | (x << 2)) & np.uint64(0x09249249)
        return x

    code = spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1)) \
        | (spread(q[:, 2]) << np.uint64(2))
    return np.argsort(code, kind="stable")


def _tile_mt(mesh: MeshTable, tile: int, o, d):
    """Moller-Trumbore of rays o, d (N, 3) against one 128-triangle tile ->
    (t, b1, b2) (N, 128), t = inf where the triangle is not hit. Each
    product and sum rounds on its own, in the order K14 computes them
    (`csrc/mesh_kernel.cu::mt_hit`). Every pair gets its determinant and
    b1; the rest of the test only the pairs with b1 in [0, 1] (a hit's
    b1 + b2 <= 1 with b2 >= 0 bounds b1 by 1)."""
    sl = slice(tile * _TILE, (tile + 1) * _TILE)
    v0, e1, e2 = mesh.v0[sl], mesh.e1[sl], mesh.e2[sl]
    ox, oy, oz = (o[:, c:c + 1] for c in range(3))      # (N, 1)
    dx, dy, dz = (d[:, c:c + 1] for c in range(3))
    e1x, e1y, e1z = e1.unbind(-1)                       # (128,)
    e2x, e2y, e2z = e2.unbind(-1)
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    adet = det.abs()
    inv_det = 1.0 / torch.where(adet < 1e-12, 1.0, det)
    tx, ty, tz = ox - v0[:, 0], oy - v0[:, 1], oz - v0[:, 2]
    b1 = (tx * px + ty * py + tz * pz) * inv_det
    # padding triangles (zero edges) never pass the determinant test
    thr = torch.where(mesh.valid[sl], 1e-12, torch.inf)
    r, k = ((adet > thr) & (b1 >= 0.0) & (b1 <= 1.0)).nonzero(as_tuple=True)
    tx, ty, tz, inv = tx[r, k], ty[r, k], tz[r, k], inv_det[r, k]
    e1x, e1y, e1z, e2x, e2y, e2z = (x[k] for x in (e1x, e1y, e1z,
                                                   e2x, e2y, e2z))
    dx, dy, dz = dx[r, 0], dy[r, 0], dz[r, 0]
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    b2_rk = (dx * qx + dy * qy + dz * qz) * inv
    t_rk = (e2x * qx + e2y * qy + e2z * qz) * inv
    hit = (b2_rk >= 0.0) & (b1[r, k] + b2_rk <= 1.0) & (t_rk > _RAY_EPS)
    t = torch.full_like(b1, torch.inf)
    t[r[hit], k[hit]] = t_rk[hit]
    b2 = torch.zeros_like(b1)
    b2[r, k] = b2_rk
    return t, b1, b2


def _tile_hits(mesh: MeshTable, tile: int, o, d):
    """Per-ray best within one tile -> (t, b1, b2, local index)."""
    t, b1, b2 = _tile_mt(mesh, tile, o, d)
    best = t.argmin(-1, keepdim=True)          # first minimum: lowest index
    return (t.gather(-1, best)[:, 0], b1.gather(-1, best)[:, 0],
            b2.gather(-1, best)[:, 0], best[:, 0])


def _tile_spheres(mesh: MeshTable):
    """(centres (n_tiles, 3), radii (n_tiles,)) of spheres about each
    tile's valid triangles (their corners v0, v0 + e1, v0 + e2), padded by
    1e-3 of the radius and 1e-4; radius -1 for a tile of padding alone."""
    with torch.no_grad():
        corners = torch.stack([mesh.v0, mesh.v0 + mesh.e1,
                               mesh.v0 + mesh.e2], 1).reshape(-1, _TILE, 3,
                                                              3)
        valid = mesh.valid.reshape(-1, _TILE, 1, 1)
        lo = torch.where(valid, corners, torch.inf).amin((1, 2))
        hi = torch.where(valid, corners, -torch.inf).amax((1, 2))
        any_valid = valid.reshape(valid.shape[0], -1).any(-1)
        centre = torch.where(any_valid[:, None], 0.5 * (lo + hi), 0.0)
        radius = torch.linalg.vector_norm(
            torch.where(any_valid[:, None], hi - lo, 0.0), dim=-1)
        return centre, torch.where(any_valid, 0.5005 * radius + 1e-4, -1.0)


def _near_tile(spheres, tile: int, o, d):
    """(N,) indices of the rays whose line passes within the tile's padded
    sphere, the distance taken through |(c - o) x d| / |d| and padded by
    1e-5 of |c - o| against its rounding. A ray that hits a triangle of
    the tile meets the sphere there, so every such ray is kept."""
    with torch.no_grad():
        centre, radius = spheres[0][tile], spheres[1][tile]
        v = centre - o
        cr = torch.linalg.cross(v, d, dim=-1)
        reach = radius + 1e-5 * torch.linalg.vector_norm(v, dim=-1)
        near = (cr * cr).sum(-1) <= reach * reach * (d * d).sum(-1)
        return (near & (radius >= 0.0)).nonzero()[:, 0]


def _closest_plain(mesh: MeshTable, o, d):
    """The closest hit of rays o, d (N, 3) -> (t, b1, b2, tri int64); t =
    inf and tri = -1 on a miss: the dense scan's results, a tile tested
    on the rays `_near_tile` keeps."""
    out, step = [], _PLAIN_RAYS[o.device.type]
    spheres = _tile_spheres(mesh)
    for r0 in range(0, o.shape[0], step):
        oc, dc = o[r0:r0 + step], d[r0:r0 + step]
        bt = torch.full(oc.shape[:1], torch.inf, device=o.device)
        bb1, bb2 = torch.zeros_like(bt), torch.zeros_like(bt)
        btri = torch.full(oc.shape[:1], -1, dtype=torch.int64,
                          device=o.device)
        for tile in range(mesh.v0.shape[0] // _TILE):
            near = _near_tile(spheres, tile, oc, dc)
            if near.shape[0] == 0:
                continue
            t, b1, b2, local = _tile_hits(mesh, tile, oc[near], dc[near])
            closer = t < bt[near]

            def update(best, new):
                return best.index_put((near,),
                                      torch.where(closer, new, best[near]))
            bt, bb1, bb2 = update(bt, t), update(bb1, b1), update(bb2, b2)
            btri = update(btri, tile * _TILE + local)
        out.append((bt, bb1, bb2, btri))
    return tuple(torch.cat(x) for x in zip(*out))


def _occluded_plain(mesh: MeshTable, o, d, maxt):
    """The any-hit test of rays o, d (N, 3) within (eps, maxt), maxt (N,)
    (`tpusky/render/mesh.py:492-501`): the dense scan's results, a tile
    tested on the rays `_near_tile` keeps."""
    out, step = [], _PLAIN_RAYS[o.device.type]
    spheres = _tile_spheres(mesh)
    for r0 in range(0, o.shape[0], step):
        oc, dc = o[r0:r0 + step], d[r0:r0 + step]
        mt = maxt[r0:r0 + step, None]
        occ = torch.zeros(oc.shape[:1], dtype=torch.bool, device=o.device)
        for tile in range(mesh.v0.shape[0] // _TILE):
            near = _near_tile(spheres, tile, oc, dc)
            if near.shape[0] == 0:
                continue
            hit = (_tile_mt(mesh, tile, oc[near], dc[near])[0]
                   < mt[near]).any(-1)
            occ = occ.index_put((near,), occ[near] | hit)
        out.append(occ)
    return torch.cat(out)


def _shade_at_hit(mesh: MeshTable, b1, b2, tri):
    """(shading normal, material index) at barycentric (b1, b2) of tri."""
    tri_c = tri.clamp(min=0).long()
    n = ((1.0 - b1 - b2)[..., None] * mesh.n0[tri_c]
         + b1[..., None] * mesh.n1[tri_c] + b2[..., None] * mesh.n2[tri_c])
    n = n / torch.linalg.vector_norm(n, dim=-1, keepdim=True).clamp(min=1e-12)
    return n, mesh.bsdf_idx[tri_c]


def _octant(d):
    return (((d[..., 0] < 0).long() << 2) | ((d[..., 1] < 0).long() << 1)
            | (d[..., 2] < 0).long())


def _key_bounds(mesh: MeshTable):
    """(lo, hi) (3,): the mesh bounds the sort key quantises origins over,
    padding triangles included (`tpusky/render/mesh.py:321-322`)."""
    with torch.no_grad():
        lo = mesh.v0.amin(0)
        hi = (mesh.v0 + torch.maximum(mesh.e1, mesh.e2)).amax(0)
    return lo, hi


def _ray_sort_order(mesh: MeshTable, o, d, bounds=None):
    """(order, inverse) permutations of a wavefront: key = direction octant
    (3 bits, major) then the 27-bit Morton code of the origin quantised
    over the mesh bounds (`_key_bounds`, or `bounds` computed by it),
    sorted stably (`tpusky/render/mesh.py:304-342`: the same float
    operations on the key, so the same permutation)."""
    lo, hi = _key_bounds(mesh) if bounds is None else bounds
    ext = (hi - lo).clamp(min=1e-12)
    q = ((o - lo) / ext * 511.0).clamp(0.0, 511.0).long()

    def spread(x):                       # 9 bits -> every 3rd bit
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    morton = (spread(q[..., 0]) | (spread(q[..., 1]) << 1)
              | (spread(q[..., 2]) << 2))
    key = (_octant(d) << 27) | morton
    order = torch.argsort(key, stable=True)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], device=order.device)
    return order, inv


def _wavefront_coherent(d) -> bool:
    """Mean direction-octant run length >= 64 (camera and shadow
    wavefronts; bounce wavefronts scramble octants lane by lane)."""
    octant = _octant(d)
    changes = (octant[1:] != octant[:-1]).sum()
    return int(changes) * 64 < octant.shape[0]


def _carries_gradient(*tensors) -> bool:
    """Whether any tensor is differentiated: it requires grad (with
    grad mode on) or carries a forward-mode tangent."""
    return any(t is not None and (
        (t.requires_grad and torch.is_grad_enabled())
        or fwAD.unpack_dual(t).tangent is not None) for t in tensors)


def _detached(mesh: MeshTable) -> MeshTable:
    return MeshTable(*(t.detach() if isinstance(t, torch.Tensor) else t
                       for t in mesh))


def _attached_hit(mesh: MeshTable, o, d, tri):
    """(t, b1, b2) of rays o, d (N, 3) at their triangles tri (N,) (-1 a
    miss), differentiable in the mesh's v0, e1, e2 and in the rays:
    Moller-Trumbore at that one triangle with `_tile_mt`'s roundings, so
    the values are the plain version's and so are the gradients. A miss
    keeps the plain version's t = inf and b1 = b2 = 0, with gradients
    that stay finite (its determinant is replaced before the division)."""
    hit = tri >= 0
    k = tri.clamp(min=0)
    v0, e1, e2 = mesh.v0[k], mesh.e1[k], mesh.e2[k]
    ox, oy, oz = o.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    e1x, e1y, e1z = e1.unbind(-1)
    e2x, e2y, e2z = e2.unbind(-1)
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    inv = 1.0 / torch.where(hit & (det.abs() >= 1e-12), det, 1.0)
    tx, ty, tz = ox - v0[:, 0], oy - v0[:, 1], oz - v0[:, 2]
    b1 = (tx * px + ty * py + tz * pz) * inv
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    b2 = (dx * qx + dy * qy + dz * qz) * inv
    t = (e2x * qx + e2y * qy + e2z * qz) * inv
    return (torch.where(hit, t, torch.inf), torch.where(hit, b1, 0.0),
            torch.where(hit, b2, 0.0))


def _closest(mesh: MeshTable, o, d, plain: bool, tables=None):
    """Closest hit of rays o, d (N, 3) -> (t, b1, b2, tri int64); on the
    card with K14's `tables` of the mesh, built here if not given. A mesh
    or rays that carry a gradient: K14 on detached copies picks the
    triangle, `_attached_hit` differentiates the hit."""
    if plain or o.device.type == "cpu":
        return _closest_plain(mesh, o, d)
    if o.device.type != "cuda":
        raise ValueError(f"mesh intersection: unsupported device {o.device}")
    if _carries_gradient(mesh.v0, mesh.e1, mesh.e2, o, d):
        tri = _closest(_detached(mesh), o.detach(), d.detach(), plain,
                       tables)[3]
        return (*_attached_hit(mesh, o, d, tri), tri)
    from ..ops.cuda.mesh_kernel import mesh_intersect_kernel, mesh_tables
    if tables is None:
        tables = mesh_tables(mesh)
    # The reference branches with lax.cond on the device; here the branch
    # is Python, on one host read of the coherence test, taken only for
    # small meshes (large ones always sort)
    if (mesh.v0.shape[0] <= _ADAPTIVE_SORT_MAX_TRIS
            and _wavefront_coherent(d)):
        t, b1, b2, tri, _ = mesh_intersect_kernel(mesh, o.contiguous(),
                                                  d.contiguous(), tables)
        return t, b1, b2, tri.long()
    order, inv = _ray_sort_order(mesh, o, d,
                                 (tables.key_lo, tables.key_hi))
    t, b1, b2, tri, _ = mesh_intersect_kernel(
        mesh, o[order].contiguous(), d[order].contiguous(), tables)
    return t[inv], b1[inv], b2[inv], tri.long()[inv]


def mesh_intersect(mesh: MeshTable, o, d, plain: bool = False,
                   tables=None):
    """Closest hit against all triangles -> (t, n_shading, mat_idx, b1, b2,
    tri_idx, hit); t = inf and tri_idx = -1 on a miss. `tables`: K14's
    tables of the mesh (`ops/cuda/mesh_kernel.py::mesh_tables`), for a
    caller that queries the mesh more than once."""
    batch = o.shape[:-1]
    t, b1, b2, tri = _closest(mesh, o.reshape(-1, 3), d.reshape(-1, 3), plain,
                              tables)
    t, b1, b2, tri = (x.reshape(batch) for x in (t, b1, b2, tri))
    hit = torch.isfinite(t) & (tri >= 0)
    return (t,) + _shade_at_hit(mesh, b1, b2, tri) + (b1, b2, tri, hit)


def mesh_test(mesh: MeshTable, o, d, maxt, plain: bool = False,
              tables=None):
    """Any hit within (eps, maxt) -> bool (...,); maxt a scalar or (...,).
    On the card the closest hit of K14 against maxt, as the reference's
    TPU path (`tpusky/render/mesh.py:461-488`); `tables` as in
    `mesh_intersect`."""
    batch = o.shape[:-1]
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    if plain or o.device.type == "cpu":
        maxt = torch.as_tensor(maxt, dtype=o.dtype, device=o.device)
        return _occluded_plain(mesh, o, d,
                               maxt.expand(batch).reshape(-1)).reshape(batch)
    # a boolean: K14 on detached copies
    t, _, _, tri = _closest(_detached(mesh), o.detach(), d.detach(), plain,
                            tables)
    t, tri = t.reshape(batch), tri.reshape(batch)
    return torch.isfinite(t) & (tri >= 0) & (t < maxt)


def _interp_corners(corners, tri, b1, b2):
    """Barycentric interpolation of per-corner rows (T, 3, k) at hits
    (`tpusky/render/mesh.py:169-185`); a miss reads triangle 0."""
    c = corners[tri.clamp(min=0)]
    return ((1.0 - b1 - b2)[..., None] * c[..., 0, :]
            + b1[..., None] * c[..., 1, :] + b2[..., None] * c[..., 2, :])


def mesh_interp_uv(mesh: MeshTable, tri, b1, b2):
    """Texture coordinates at hits -> (..., 2)."""
    return _interp_corners(mesh.uv, tri, b1, b2)


def mesh_interp_color(mesh: MeshTable, tri, b1, b2):
    """Vertex colours at hits -> (..., 3) (the data `mesh_attribute.cpp`
    reads)."""
    return _interp_corners(mesh.col, tri, b1, b2)
