"""Textures: checkerboard, bitmap atlas, volume grid and mesh attribute.

The PyTorch counterpart of `tpusky/render/texture.py` (the reference's
`checkerboard.cpp`, `bitmap.cpp`, `volume.cpp` and `mesh_attribute.cpp`).
Every texture of a scene lives in one `TextureTable`: small per-texture
columns and one flat (A, 4) atlas that holds the texels of every bitmap
and volume grid (RGB and a spare channel, the reference's layout), so a
lookup is a gather per tap whatever the number of textures. Per-lane
parameters are read by plain indexing (the reference's one-hot fetches
are a TPU workaround).

* checkerboard: `frac(u) > 0.5` and `frac(v) > 0.5` equal -> color0,
  else color1 (`checkerboard.cpp:70-89`; defaults 0.4 and 0.2), after the
  affine `to_uv`;
* bitmap: 4 bilinear taps, uv (0, 0) the top-left texel corner, v down
  the rows, the repeat, mirror and clamp wraps;
* volume: 8 trilinear taps at the world hit point through `world_to_tex`
  (the inverse of its `to_world`), clamped to the unit cube;
* mesh attribute: the interpolated vertex colour times `attr_scale`.

In spectral mode a checker colour is an 11-point spectrum on the 320..720
nm grid, lerped at the hero wavelengths; a texel carries sigmoid
coefficients (Jakob and Hanika 2019) fitted when the table is built, with
the reference's 64-iteration host rule (`ops/rgb2spec.py`); a mesh
attribute is its channel mean. The table keeps its kinds on the host
(`host_kind`), so `table_texture_kinds` never waits for the device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.rgb2spec import fit_sigmoid_coeffs_f64, upsample_rgb
from .bsdf import spec_lerp

CHECKERBOARD, BITMAP = 0, 1
VOLUME, MESH_ATTR = 2, 3
WRAP_REPEAT, WRAP_MIRROR, WRAP_CLAMP = 0, 1, 2
_WRAPS = {"repeat": WRAP_REPEAT, "mirror": WRAP_MIRROR, "clamp": WRAP_CLAMP}

_LAM_MIN, _LAM_MAX = 360.0, 830.0   # the sigmoid coefficients' frame


class TextureTable(NamedTuple):
    """The textures of a scene, T of them (the reference's field order)."""
    kind: torch.Tensor          # (T,) int64
    color0: torch.Tensor        # (T, 3) checker colour (RGB)
    color1: torch.Tensor        # (T, 3)
    color0_spec: torch.Tensor   # (T, 11) checker colour at 320..720 nm
    color1_spec: torch.Tensor   # (T, 11)
    uv_transform: torch.Tensor  # (T, 3, 3) affine `to_uv`
    wrap: torch.Tensor          # (T,) int64 wrap mode
    offset: torch.Tensor        # (T,) int64 first texel in the atlas
    width: torch.Tensor         # (T,) int64
    height: torch.Tensor        # (T,) int64
    atlas: torch.Tensor         # (A, 4) texel RGB and a spare channel
    atlas_coeff: torch.Tensor   # (A, 4) sigmoid c0..c2 and scale (spectral)
    depth: torch.Tensor         # (T,) int64 a volume's z extent (else 1)
    world_to_tex: torch.Tensor  # (T, 4, 4) world -> [0, 1]^3 (volumes)
    attr_scale: torch.Tensor    # (T,) a mesh attribute's scale
    host_kind: Optional[tuple] = None   # `kind` as Python ints


def _texel_rows(grid, spectral: bool, device):
    """(texels (M, 4), coefficients (M, 4)) of an (..., 3) texel array:
    RGB and a zero channel; in spectral mode each texel's sigmoid
    coefficients fitted on rgb / max(rgb, 1) in float64 on `device`, and
    that scale (`tpusky/render/texture.py:108-111, 146-149`)."""
    flat = grid.reshape(-1, 3)
    texels = np.concatenate([flat, np.zeros((flat.shape[0], 1), np.float32)],
                            -1)
    if not spectral:
        return texels, np.zeros_like(texels)
    scale = np.maximum(flat.max(-1), 1.0)
    target = torch.tensor(flat / scale[:, None], dtype=torch.float64,
                          device=device)
    coeffs = fit_sigmoid_coeffs_f64(target).to(torch.float32).cpu().numpy()
    return texels, np.concatenate(
        [coeffs, scale[:, None].astype(np.float32)], -1)


def make_texture_table(textures, spectral: bool = False,
                       device="cuda") -> TextureTable:
    """Build a TextureTable from host-side descriptions (the reference
    package's dicts):

      {kind: 'checkerboard', color0, color1, to_uv (3x3)?}
      {kind: 'bitmap', data (H, W[, 1|3]), to_uv?, wrap: 'repeat' |
       'mirror' | 'clamp'}
      {kind: 'volume', grid (D, H, W[, 1|3]), to_world (4x4)?}
      {kind: 'mesh_attribute', scale?}

    `spectral=True` also fits every texel's sigmoid coefficients, on
    `device` (`rgb2spec.fit_sigmoid_coeffs_f64`, the host fit's rule)."""
    t = len(textures)
    kind = np.zeros((t,), np.int64)
    c0 = np.full((t, 3), 0.4, np.float32)
    c1 = np.full((t, 3), 0.2, np.float32)
    c0s = np.full((t, 11), 0.4, np.float32)
    c1s = np.full((t, 11), 0.2, np.float32)
    uvt = np.tile(np.eye(3, dtype=np.float32), (t, 1, 1))
    wrap = np.zeros((t,), np.int64)
    offset = np.zeros((t,), np.int64)
    width = np.ones((t,), np.int64)
    height = np.ones((t,), np.int64)
    depth = np.ones((t,), np.int64)
    w2t = np.tile(np.eye(4, dtype=np.float32), (t, 1, 1))
    attr_scale = np.ones((t,), np.float32)
    blobs = []
    n_texels = 0
    wl_grid = np.arange(320.0, 721.0, 40.0)

    def rgb3(a, ndim):
        a = np.asarray(a, np.float32)
        if a.ndim == ndim:
            a = a[..., None]
        if a.shape[-1] == 1:
            a = np.repeat(a, 3, axis=-1)
        return a[..., :3]

    for i, d in enumerate(textures):
        if d.get("to_uv") is not None:
            uvt[i] = np.asarray(d["to_uv"], np.float32).reshape(3, 3)
        if d["kind"] == "mesh_attribute":
            kind[i] = MESH_ATTR
            attr_scale[i] = float(d.get("scale", 1.0))
            continue
        if d["kind"] == "checkerboard":
            kind[i] = CHECKERBOARD
            c0[i] = np.asarray(d.get("color0", 0.4), np.float32) \
                * np.ones(3, np.float32)
            c1[i] = np.asarray(d.get("color1", 0.2), np.float32) \
                * np.ones(3, np.float32)
            c0s[i] = upsample_rgb(c0[i], wl_grid)[0]
            c1s[i] = upsample_rgb(c1[i], wl_grid)[0]
            continue
        if d["kind"] == "volume":
            kind[i] = VOLUME
            grid = rgb3(d["grid"], 3)
            depth[i], height[i], width[i] = grid.shape[:3]
            w2t[i] = np.linalg.inv(np.asarray(d.get("to_world", np.eye(4)),
                                              np.float32))
        elif d["kind"] == "bitmap":
            kind[i] = BITMAP
            grid = rgb3(d["data"], 2)
            height[i], width[i] = grid.shape[:2]
            wrap[i] = _WRAPS[d.get("wrap", "repeat")]
        else:
            raise NotImplementedError(f"texture kind {d['kind']!r}")
        offset[i] = n_texels
        blobs.append(_texel_rows(grid, spectral, device))
        n_texels += blobs[-1][0].shape[0]

    if blobs:
        atlas = np.concatenate([b[0] for b in blobs])
        atlas_c = np.concatenate([b[1] for b in blobs])
    else:   # one texel keeps every gather valid
        atlas = atlas_c = np.zeros((1, 4), np.float32)

    def f32(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    def i64(x):
        return torch.tensor(np.asarray(x, np.int64), device=device)
    return TextureTable(i64(kind), f32(c0), f32(c1), f32(c0s), f32(c1s),
                        f32(uvt), i64(wrap), i64(offset), i64(width),
                        i64(height), f32(atlas), f32(atlas_c), i64(depth),
                        f32(w2t), f32(attr_scale),
                        tuple(int(k) for k in kind))


def table_texture_kinds(tex: Optional[TextureTable]) -> tuple:
    """The sorted kinds a table holds (() for no table), from its host
    copy (or from `kind` itself where it lies on the CPU)."""
    if tex is None:
        return ()
    ks = tex.host_kind
    if ks is None:
        if tex.kind.device.type != "cpu":
            raise ValueError("table_texture_kinds: the table has no host "
                             "copy of its kinds (build it with "
                             "make_texture_table or pass host_kind)")
        ks = tex.kind.tolist()
    return tuple(sorted(set(int(k) for k in ks)))


def _wrap_coord(x, n, mode):
    """Texel coordinates x (float) wrapped per lane by mode into [0, n-1]
    (`tpusky/render/texture.py:180-190`)."""
    nf = n.to(x.dtype)
    rep = x - nf * torch.floor(x / nf)
    period = 2.0 * nf
    m = x - period * torch.floor(x / period)
    mir = torch.where(m >= nf, period - 1.0 - m, m)
    clp = torch.minimum(torch.maximum(x, torch.zeros_like(x)), nf - 1.0)
    out = torch.where(mode == WRAP_REPEAT, rep,
                      torch.where(mode == WRAP_MIRROR, mir, clp))
    return torch.minimum(torch.maximum(out, torch.zeros_like(out)), nf - 1.0)


def _sigmoid_eval(coeffs, wavelengths):
    """Per-lane sigmoid spectra: coeffs (..., 4) = (c0, c1, c2, scale) at
    (..., W) wavelengths -> (..., W)."""
    x = (wavelengths - _LAM_MIN) / (_LAM_MAX - _LAM_MIN)
    t = coeffs[..., 0:1] * x * x + coeffs[..., 1:2] * x + coeffs[..., 2:3]
    return (0.5 + 0.5 * t / torch.sqrt(1.0 + t * t)) * coeffs[..., 3:4]


def _fetch(tex: TextureTable, flat, wavelengths):
    """The texels at atlas rows `flat` (...,): RGB (..., 3), or their
    spectra at the wavelengths (..., W)."""
    if wavelengths is None:
        return tex.atlas[flat][..., :3]
    return _sigmoid_eval(tex.atlas_coeff[flat], wavelengths)


def eval_texture(tex: TextureTable, tex_idx, uv, wavelengths=None, p=None,
                 attr=None, tkinds=None):
    """Per-lane textures -> (value (..., C), has (...,)); value is
    undefined where has is False (tex_idx < 0). uv (..., 2); `p` (..., 3)
    the world hit point (volumes); `attr` (..., 3) the interpolated vertex
    colour (mesh attributes; a mesh-attribute lane without one reads 0);
    `wavelengths` (..., W) for spectral values; `tkinds` the kinds to
    evaluate (`table_texture_kinds`, read here when None). The reference
    is `tpusky/render/texture.py:209-373`, op for op."""
    if tkinds is None:
        tkinds = table_texture_kinds(tex)
    has = tex_idx >= 0
    idx = tex_idx.clamp(min=0)
    kind = tex.kind[idx]
    nc = 3 if wavelengths is None else wavelengths.shape[-1]

    extra = None            # (lanes, values) of the volume / attribute
    if VOLUME in tkinds and p is not None:
        m4 = tex.world_to_tex[idx]
        q = [m4[..., r, 0] * p[..., 0] + m4[..., r, 1] * p[..., 1]
             + m4[..., r, 2] * p[..., 2] + m4[..., r, 3] for r in range(3)]
        dims = (tex.width[idx], tex.height[idx], tex.depth[idx])
        f = [q[a].clamp(0.0, 1.0) * dims[a].to(q[a].dtype) - 0.5
             for a in range(3)]
        c0 = [torch.floor(x) for x in f]
        tw = [x - x0 for x, x0 in zip(f, c0)]
        off = tex.offset[idx]

        def vtap(dx, dy, dz):
            ii = [torch.minimum(torch.maximum(c + s, torch.zeros_like(c)),
                                n.to(c.dtype) - 1.0).long()
                  for c, s, n in zip(c0, (dx, dy, dz), dims)]
            return _fetch(tex, off + (ii[2] * dims[1] + ii[1]) * dims[0]
                          + ii[0], wavelengths)
        tri = 0.0
        for dz, wz in ((0.0, 1.0 - tw[2]), (1.0, tw[2])):
            for dy, wy in ((0.0, 1.0 - tw[1]), (1.0, tw[1])):
                for dx, wx in ((0.0, 1.0 - tw[0]), (1.0, tw[0])):
                    tri = tri + (wz * wy * wx)[..., None] * vtap(dx, dy, dz)
        extra = (kind == VOLUME, tri)

    if MESH_ATTR in tkinds and attr is not None:
        v_attr = attr * tex.attr_scale[idx][..., None]
        if wavelengths is not None:
            # the channel mean: a constant spectrum
            v_attr = v_attr.mean(-1, keepdim=True).expand(
                v_attr.shape[:-1] + (nc,))
        mask = kind == MESH_ATTR
        extra = ((mask, v_attr) if extra is None else
                 (extra[0] | mask,
                  torch.where(mask[..., None], v_attr, extra[1])))

    m = tex.uv_transform[idx]
    u = m[..., 0, 0] * uv[..., 0] + m[..., 0, 1] * uv[..., 1] + m[..., 0, 2]
    v = m[..., 1, 0] * uv[..., 0] + m[..., 1, 1] * uv[..., 1] + m[..., 1, 2]
    # a miss lane's uv may be inf or NaN: its value is masked downstream,
    # but a non-finite bilinear weight would make 0 * NaN in the atlas's
    # gradient, so such lanes look up an inner point
    ok_uv = torch.isfinite(u) & torch.isfinite(v) & has
    u = torch.where(ok_uv, u, 0.5)
    v = torch.where(ok_uv, v, 0.5)
    value = torch.zeros(idx.shape + (nc,), device=uv.device)

    if CHECKERBOARD in tkinds:
        use0 = ((u - torch.floor(u)) > 0.5) == ((v - torch.floor(v)) > 0.5)
        if wavelengths is None:
            col0, col1 = tex.color0[idx], tex.color1[idx]
        else:
            col0 = spec_lerp(tex.color0_spec[idx], wavelengths)
            col1 = spec_lerp(tex.color1_spec[idx], wavelengths)
        value = torch.where((kind == CHECKERBOARD)[..., None],
                            torch.where(use0[..., None], col0, col1), value)

    if BITMAP in tkinds:
        w_t, h_t = tex.width[idx], tex.height[idx]
        off, wrap = tex.offset[idx], tex.wrap[idx]
        fx = u * w_t.to(u.dtype) - 0.5
        fy = v * h_t.to(v.dtype) - 0.5
        x0, y0 = torch.floor(fx), torch.floor(fy)
        tx, ty = fx - x0, fy - y0

        def tap(xc, yc):
            xw = _wrap_coord(xc, w_t, wrap).long()
            yw = _wrap_coord(yc, h_t, wrap).long()
            return _fetch(tex, off + yw * w_t + xw, wavelengths)
        bi = (((1 - tx) * (1 - ty))[..., None] * tap(x0, y0)
              + (tx * (1 - ty))[..., None] * tap(x0 + 1.0, y0)
              + ((1 - tx) * ty)[..., None] * tap(x0, y0 + 1.0)
              + (tx * ty)[..., None] * tap(x0 + 1.0, y0 + 1.0))
        value = torch.where((kind == BITMAP)[..., None], bi, value)

    if extra is not None:
        value = torch.where(extra[0][..., None], extra[1], value)
    return value, has
