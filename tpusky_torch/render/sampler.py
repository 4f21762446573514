"""Samplers: per-lane counter-hash uniforms.

The `independent` kind of `tpusky/render/sampler.py`, bitwise: uniforms
are keyed on (lane = pixel * spp + sample, stream = dim * 64 + channel,
seed), so they do not depend on device layout or chunking. The seed is a
plain integer; for a JAX key made by `PRNGKey(s)` the reference package
uses `key_data(key)[-1] == s`.

The u32 arithmetic runs in int64 with explicit wrapping: torch's uint32
lacks wrapping multiplies on the CPU, and a 32 x 32-bit product does not
fit int64, so `_mul32` splits the constant into 16-bit halves.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """(x * c) mod 2^32 for int64 x in [0, 2^32) and a u32 constant c."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _hash_u32(x):
    """xxhash-style avalanche on u32 values held in int64."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def _u32_to_unit(x):
    return (x >> 8).to(torch.float32) * (1.0 / (1 << 24))


def lane_samples(kind: str, seed: int, pixel_idx, sample_idx, spp: int,
                 dim: int, n: int):
    """n uniform samples for each lane -> (..., n) float32.

    pixel_idx, sample_idx: int64 tensors identifying the lane. `dim` is a
    static per-use-site stream id; each (dim, channel) pair maps to stream
    `dim * 64 + channel`.
    """
    if kind != "independent":
        raise NotImplementedError(f"sampler {kind!r}")
    if n > 64:
        raise ValueError("lane_samples supports at most 64 channels per dim")
    seed = int(seed) & _M32
    lane = (_mul32(pixel_idx, max(spp, 1)) + sample_idx) & _M32
    lane_mix = _mul32(lane, 0x85EBCA6B)
    lane_salt = (lane + 0x9E3779B9) & _M32
    out = []
    for c in range(n):
        dc = (dim * 64 + c) & _M32
        h = _hash_u32((lane_mix + ((dc * 0xC2B2AE35) & _M32) + seed) & _M32)
        h = _hash_u32(h ^ lane_salt)
        out.append(_u32_to_unit(_hash_u32((h + dc) & _M32)))
    return torch.stack(out, -1)
