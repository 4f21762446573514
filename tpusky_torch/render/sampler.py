"""Samplers: per-lane counter-hash uniforms, and the key's fold-in.

The `independent` kind of `tpusky/render/sampler.py`, bitwise: uniforms
are keyed on (lane = pixel * spp + sample, stream = dim * 64 + channel,
seed), so they do not depend on device layout or chunking. The seed is a
plain integer; for a JAX key made by `PRNGKey(s)` the reference package
uses `key_data(key)[-1] == s`. `fold_in` derives a pass's key from the
reference's threefry key words on the host.

The u32 arithmetic runs in int64 with explicit wrapping: torch's uint32
lacks wrapping multiplies on the CPU, and a 32 x 32-bit product does not
fit int64, so `_mul32` splits the constant into 16-bit halves.
"""

from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_THREEFRY_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def fold_in(key, data: int):
    """`jax.random.fold_in` on a threefry-2x32 key's two uint32 words
    (`np.asarray(jax.random.key_data(key))`) -> the new key's words
    (uint32 (2,)): threefry-2x32, 20 rounds, of the counter (0, data)
    under the key (Salmon et al. 2011), in Python integers."""
    k0, k1 = (int(k) for k in np.asarray(key, np.uint32).reshape(2))
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0, x1 = k0, (int(data) + k1) & _M32
    for i in range(5):
        for r in _THREEFRY_ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return np.array([x0, x1], np.uint32)


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
