"""AOV integrator: depth, position, uv, primitive and shape index, normals
and albedo at each pixel's centre, with an optional nested integrator.

The PyTorch counterpart of `tpusky/render/aov.py` (the reference's
`aov.cpp` and `depth.cpp`): one ray a pixel through its centre, the
analytic shapes, the mesh (kernel K14 on the card), the SDF grid and the
curves intersected as the path tracer does (an SDF or curve hit keeps the
shapes' geometric normal, uv and primitive, as the reference's), and the
reference's `aovs` spec string
`"name:type,..."` (`aov.cpp:111`). A nested child integrator ("path",
"direct" or a callable) adds its image under its name (`aov.cpp:126-137`),
rendered through the port's `render`.

Two departures from the reference package, both ROADMAP.md Queue 3:
the child's key is `child_seed`, which defaults to the reference's fixed
`PRNGKey(0)` (R2: the reference ignores any other); and the albedo of a
textured material is its texture at the hit, as Mitsuba 3's `aov.cpp`
reads it through `BSDF::eval_diffuse_reflectance` (R11: the reference
reads the untextured column).
"""

from __future__ import annotations

import torch

from . import sensors as sensors_mod
from .curve import curve_intersect
from .mesh import mesh_interp_color, mesh_interp_uv, mesh_intersect
from .sdf import sdf_intersect
from .shapes import ray_intersect
from .texture import eval_texture

# the reference's PRNGKey(0) as the two uint32 words `render` takes
REFERENCE_CHILD_KEY = (0, 0)
# the `aovs` spec's type names (`aov.cpp:111-147`) -> channels
_ALIAS = {"dd": "depth", "depth": "depth", "position": "position",
          "uv": "uv", "prim_index": "prim_index",
          "shape_index": "shape_idx", "geo_normal": "geo_normal",
          "sh_normal": "sh_normal", "nn": "sh_normal", "albedo": "albedo"}


def _child_image(scene, sensor, height, width, child, child_kwargs,
                 child_seed):
    """(name, image) of the nested integrator."""
    from . import integrator
    from .film import Film
    if callable(child):
        return (getattr(child, "__name__", "child"),
                child(scene, sensor, height, width))
    kw = dict(spp=16, max_depth=2, mode="rgb")
    kw.update(child_kwargs or {})
    name = str(child)
    return name, integrator.render(
        scene, sensor, Film(height, width, 3),
        REFERENCE_CHILD_KEY if child_seed is None else child_seed,
        spp=kw["spp"], max_depth=kw["max_depth"] if name != "direct" else 2,
        mode=kw["mode"])


def render_aovs(scene, sensor, height: int, width: int, aovs=None,
                child=None, child_kwargs=None, child_seed=None,
                plain: bool = False):
    """Feature channels at pixel centres -> dict: 'depth' (H, W),
    'normal', 'sh_normal', 'geo_normal', 'position', 'albedo' (H, W, 3),
    'uv' (H, W, 2), 'shape_idx' and 'prim_index' (H, W) int64 (-2 the
    mesh's shape index, -3 the SDF's, -4 a curve's; -1 a miss's or an
    analytic shape's primitive).

    `aovs` ("name:type,...") maps each requested name to its channel;
    `child` ("path", "direct" or a callable(scene, sensor, H, W)) adds
    its (H, W, 3) image under its name, a string child rendered with
    `child_kwargs` (spp 16, max_depth 2, mode "rgb" by default) at
    `child_seed` (an integer seed or a key's two uint32 words; None: the
    reference's PRNGKey(0)). `plain` runs the mesh's plain intersection
    on the card, the reference K14 is held against."""
    dev = scene.shapes.to_world.device
    y, x = torch.meshgrid(torch.arange(height, device=dev),
                          torch.arange(width, device=dev), indexing="ij")
    pix = torch.stack([(x.reshape(-1) + 0.5) / width,
                       (y.reshape(-1) + 0.5) / height], -1)
    o, d = sensors_mod.sample_ray(sensor, pix)

    t, p, n, uv, shape_idx, hit = ray_intersect(scene.shapes, o, d, uv=True)
    geo_n = n
    prim = torch.full_like(shape_idx, -1)
    mat = scene.shapes.bsdf_idx[shape_idx.clamp(min=0)]
    attr = None
    if scene.mesh is not None:
        mesh = scene.mesh
        tm, nm, matm, b1, b2, tri, hitm = mesh_intersect(
            mesh, o, d, plain=plain, tables=scene.mesh_tables)
        use = hitm & (tm < t)
        t = torch.where(use, tm, t)
        p = torch.where(use[..., None], o + tm[..., None] * d, p)
        n = torch.where(use[..., None], nm, n)
        # the winning triangle's geometric normal
        tri_c = tri.clamp(min=0)
        gn = torch.linalg.cross(mesh.e1[tri_c], mesh.e2[tri_c])
        gn = gn / gn.norm(dim=-1, keepdim=True).clamp(min=1e-12)
        geo_n = torch.where(use[..., None], gn, geo_n)
        uv = torch.where(use[..., None], mesh_interp_uv(mesh, tri, b1, b2),
                         uv)
        if mesh.col is not None:
            attr = torch.where(use[..., None],
                               mesh_interp_color(mesh, tri, b1, b2), 0.0)
        prim = torch.where(use, tri, prim)
        mat = torch.where(use, matm, mat)
        shape_idx = torch.where(use, -2, shape_idx)
        hit = hit | hitm
    hits = []
    if scene.sdf is not None:
        ts, ns, hs = sdf_intersect(scene.sdf, o, d)
        hits.append((ts, ns, hs, scene.sdf.bsdf_idx, -3))
    if scene.curve is not None:
        tc, nc, matc, hc, _ = curve_intersect(scene.curve, o, d)
        hits.append((tc, nc, hc, matc, -4))
    for t_k, n_k, hit_k, mat_k, index in hits:
        # `tpusky/render/aov.py:68-88`
        use = hit_k & (t_k < t)
        t = torch.where(use, t_k, t)
        p = torch.where(use[..., None], o + t_k[..., None] * d, p)
        n = torch.where(use[..., None], n_k, n)
        mat = torch.where(use, mat_k, mat)
        shape_idx = torch.where(use, index, shape_idx)
        hit = hit | use

    albedo = scene.bsdfs.albedo[mat]
    if scene.textures is not None:
        # R11: a textured lane's albedo is its texture at the hit
        val, has = eval_texture(scene.textures, scene.bsdfs.tex_idx[mat],
                                uv, p=p, attr=attr)
        albedo = torch.where(has[..., None], val, albedo)

    def img(v):
        h = hit if v.dim() == 1 else hit[..., None]
        return torch.where(h, v, 0.0).reshape((height, width) + v.shape[1:])
    out = {"depth": img(t), "normal": img(n), "sh_normal": img(n),
           "geo_normal": img(geo_n), "position": img(p),
           "albedo": img(albedo),
           "shape_idx": shape_idx.reshape(height, width),
           "uv": img(uv),
           "prim_index": torch.where(hit, prim, -1).reshape(height, width)}
    child_name = None
    if child is not None:
        child_name, image = _child_image(scene, sensor, height, width, child,
                                         child_kwargs, child_seed)
        out[child_name] = image
    if not aovs:
        return out
    sel = {}
    for tok in str(aovs).split(","):
        tok = tok.strip()
        if not tok:
            continue
        name, _, typ = tok.partition(":")
        typ = (typ or name).strip().split(".")[0]
        sel[name.strip()] = out[_ALIAS.get(typ, typ)]
    if child_name is not None:
        sel[child_name] = out[child_name]
    return sel
