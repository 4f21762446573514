"""Samplers: per-lane counter-based uniforms, and the key's fold-in.

Every kind of `tpusky/render/sampler.py`, bitwise: uniforms are keyed on
(pixel, sample index, stream = dim * 64 + channel, seed), so they do not
depend on device layout or chunking.

Kinds:
  independent   counter-hash uniforms per (lane = pixel * spp + sample,
                stream)
  threefry      JAX's own streams: threefry-2x32 of the lane folded into
                the key, then of the dim, then `jax.random.uniform`'s
                counters (with `jax_threefry_partitionable` on, as in the
                reference's JAX: counter i is the pair (0, i) and the bits
                are the two output words xor-ed)
  stratified    jittered strata over the spp samples of each pixel, with
                a per-(pixel, stream) Cranley-Patterson rotation
  qmc           the base-2 (0,2)-sequence with per-(pixel, stream) XOR
                scrambling
  multijitter   correlated multi-jittered pairs (Kensler, Pixar memo
                13-01); needs a power-of-two spp of at least 4, else
                `stratified`
  orthogonal    Bose OA(p^2, strength 2) strata (Jarosz et al. 2019);
                needs spp = p^2 for a prime p, else `stratified`

A key is an integer seed, or the two uint32 words of the reference's
threefry key (`np.asarray(jax.random.key_data(key))`), whose seed for
the counter-hash kinds is the last word. `threefry` needs the two words.
`fold_in` derives a pass's key from the key words on the host.

The u32 arithmetic runs in int64 with explicit wrapping: torch's uint32
lacks wrapping multiplies on the CPU, and a 32 x 32-bit product does not
fit int64, so `_mul32` splits one factor into 16-bit halves. Division by
a constant is multiplication by its float32 reciprocal, and a product
that XLA contracts with a sum into a fused multiply-add is rounded once
(through float64), as XLA compiles the reference's, so the floats are
bitwise the reference's on every device.
"""

from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_THREEFRY_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))

VALID_KINDS = ("independent", "threefry", "stratified", "qmc",
               "multijitter", "orthogonal")


def _threefry2x32(k0, k1, x0, x1):
    """threefry-2x32, 20 rounds (Salmon et al. 2011), of the counter
    (x0, x1) under the key (k0, k1): u32 values as Python integers or
    int64 tensors, which broadcast."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + k0) & _M32
    x1 = (x1 + k1) & _M32
    for i in range(5):
        for r in _THREEFRY_ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def fold_in(key, data: int):
    """`jax.random.fold_in` on a threefry-2x32 key's two uint32 words
    (`np.asarray(jax.random.key_data(key))`) -> the new key's words
    (uint32 (2,)): threefry-2x32 of the counter (0, data), in Python
    integers."""
    k0, k1 = (int(k) for k in np.asarray(key, np.uint32).reshape(2))
    return np.array(_threefry2x32(k0, k1, 0, int(data) & _M32), np.uint32)


def split(key, n: int):
    """`jax.random.split(key, n)`'s keys as their words (uint32 (2,)
    each): with `jax_threefry_partitionable` on, key i is threefry-2x32 of
    the counter (0, i), which is `fold_in(key, i)`."""
    return [fold_in(key, i) for i in range(n)]


def uniform(key, shape, device="cuda"):
    """`jax.random.uniform(key, shape)` of a key's two uint32 words,
    bitwise -> float32 tensor: element i (row-major) is threefry-2x32 of
    the counter (0, i), its two words xor-ed, whose top 23 bits make a
    float in [1, 2) less one (`jax_threefry_partitionable` on, as in
    `_threefry_uniforms`)."""
    shape = tuple(shape)
    k0, k1 = (int(k) for k in np.asarray(key, np.uint32).reshape(2))
    count = int(np.prod(shape, dtype=np.int64))
    c = torch.arange(count, dtype=torch.int64, device=device)
    y0, y1 = _threefry2x32(k0, k1, c >> 32, c & _M32)
    bits = ((y0 ^ y1) >> 9) | 0x3F800000
    return (bits.to(torch.int32).view(torch.float32) - 1.0).reshape(shape)


def key_seed(key) -> int:
    """The counter-hash kinds' seed of a key: an integer seed itself, or
    the last of the key's two words (`key_data(key)[-1]`)."""
    if isinstance(key, (int, np.integer)):
        return int(key) & _M32
    return int(np.asarray(key, np.uint32).reshape(2)[-1])


def _mul32(x, c):
    """(x * c) mod 2^32 for u32 x and c, each an int64 tensor or a Python
    integer: c is split into 16-bit halves, so no product passes 2^48."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _hash_u32(x):
    """xxhash-style avalanche on u32 values held in int64 tensors or in
    Python integers (a stream's hash, with no device work)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def _u32_to_unit(x):
    return (x >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _inv(k: int) -> float:
    """The float32 reciprocal of k, by which XLA replaces a division."""
    return float(np.float32(1.0) / np.float32(k))


def _kensler_permute_pow2(i, l: int, p):
    """Pseudorandom bijection on [0, l) for power-of-two l, keyed by p."""
    w = l - 1
    i = i ^ p
    i = _mul32(i, 0xE170893D)
    i = i ^ (p >> 16)
    i = i ^ ((i & w) >> 4)
    i = i ^ (p >> 8)
    i = _mul32(i, 0x0929EB3F)
    i = i ^ (p >> 23)
    i = i ^ ((i & w) >> 1)
    i = _mul32(i, 1 | (p >> 27))
    i = _mul32(i, 0x6935FA69)
    i = i ^ ((i & w) >> 11)
    i = _mul32(i, 0x74DCCA23)
    i = i ^ (p >> 2)
    i = _mul32(i, 0x9E501CC3)
    i = i ^ ((i & w) >> 2)
    i = _mul32(i, 0xC860A3DF)
    i = i & w
    i = i ^ (i >> 5)
    return (i + p) & w


def _sobol_2d(index):
    """First two components of the base-2 (0,2)-sequence: the bit
    reversal and Sobol' dimension 1 from its direction numbers."""
    v = index
    v = ((v >> 1) & 0x55555555) | ((v & 0x55555555) << 1)
    v = ((v >> 2) & 0x33333333) | ((v & 0x33333333) << 2)
    v = ((v >> 4) & 0x0F0F0F0F) | ((v & 0x0F0F0F0F) << 4)
    v = ((v >> 8) & 0x00FF00FF) | ((v & 0x00FF00FF) << 8)
    d0 = ((v >> 16) | (v << 16)) & _M32
    result = torch.zeros_like(index)
    direction = 1 << 31
    i = index
    for _ in range(32):
        result = torch.where((i & 1) != 0, result ^ direction, result)
        direction ^= direction >> 1
        i = i >> 1
    return d0, result


def _threefry_uniforms(key, lane, dim: int, n: int):
    """`jax.random.uniform(fold_in(fold_in(key, lane), dim), (n,))` for
    each lane -> (..., n) float32."""
    if isinstance(key, (int, np.integer)):
        raise ValueError("the threefry sampler draws JAX's streams, which "
                         "need the reference key's two uint32 words, not "
                         "an integer seed")
    k0, k1 = (int(k) for k in np.asarray(key, np.uint32).reshape(2))
    a, b = _threefry2x32(k0, k1, 0, lane)
    a, b = _threefry2x32(a, b, 0, dim & _M32)
    out = []
    for c in range(n):
        y0, y1 = _threefry2x32(a, b, 0, c)
        bits = ((y0 ^ y1) >> 9) | 0x3F800000
        out.append(bits.to(torch.int32).view(torch.float32) - 1.0)
    return torch.stack(out, -1)


def lane_samples(kind: str, key, pixel_idx, sample_idx, spp: int, dim: int,
                 n: int):
    """n uniform samples for each lane -> (..., n) float32.

    pixel_idx, sample_idx: int64 tensors in [0, 2^32) identifying the
    lane. `dim` is a static per-use-site stream id; each (dim, channel)
    pair maps to stream `dim * 64 + channel`, injective for n <= 64.
    """
    if kind not in VALID_KINDS:
        raise ValueError(f"unknown sampler {kind!r}")
    if n > 64:
        raise ValueError("lane_samples supports at most 64 channels per dim")
    if kind == "threefry":
        lane = (_mul32(pixel_idx, max(spp, 1)) + sample_idx) & _M32
        return _threefry_uniforms(key, lane, dim, n)
    seed = key_seed(key)

    if kind == "independent":
        lane = (_mul32(pixel_idx, max(spp, 1)) + sample_idx) & _M32
        lane_mix = _mul32(lane, 0x85EBCA6B)
        lane_salt = (lane + 0x9E3779B9) & _M32
        out = []
        for c in range(n):
            dc = (dim * 64 + c) & _M32
            h = _hash_u32((lane_mix + ((dc * 0xC2B2AE35) & _M32) + seed)
                          & _M32)
            h = _hash_u32(h ^ lane_salt)
            out.append(_u32_to_unit(_hash_u32((h + dc) & _M32)))
        return torch.stack(out, -1)

    def stream_hash(c):
        """_hash_u32(pixel ^ _hash_u32(stream ^ seed)) of channel c."""
        return _hash_u32(pixel_idx ^ _hash_u32((dim * 64 + c) ^ seed))

    if kind == "multijitter":
        if spp < 4 or spp & (spp - 1):
            kind = "stratified"         # the CMJ grid needs 2^k spp
        else:
            k = spp.bit_length() - 1
            m = 1 << ((k + 1) // 2)
            n_g = 1 << (k // 2)                       # m * n_g == spp
            out = []
            for c0 in range(0, n, 2):
                h = stream_hash(c0)
                # the outer shuffle decorrelates the pair across dims
                s = _kensler_permute_pow2(sample_idx, spp,
                                          _mul32(h, 0x51633E2D))
                sx = _kensler_permute_pow2(s % m, m, _mul32(h, 0xA511E9B3))
                sy = _kensler_permute_pow2(s // m, n_g,
                                           _mul32(h, 0x63D83595))
                jx = _u32_to_unit(_hash_u32(s ^ _mul32(h, 0xA399D265)))
                jy = _u32_to_unit(_hash_u32(s ^ _mul32(h, 0x711AD6A5)))
                out.append(((s % m).float() + (sy.float() + jx) * _inv(n_g))
                           * _inv(m))
                if c0 + 1 < n:
                    out.append(((s // m).float()
                                + (sx.float() + jy) * _inv(m)) * _inv(n_g))
            return torch.stack(out, -1)

    if kind == "orthogonal":
        p = int(round(spp ** 0.5))
        is_prime = p >= 2 and all(p % q for q in range(2, int(p ** 0.5) + 1))
        if p * p != spp or not is_prime:
            kind = "stratified"         # Bose needs spp == prime^2
        else:
            a = sample_idx // p
            b = sample_idx % p
            out = []
            for c in range(n):
                j = dim * 64 + c
                h = stream_hash(c)
                k_j = 1 + (j % max(p - 1, 1))
                phi = (a + _mul32(b, k_j)) % p
                # per-pixel digit shifts decorrelate pixels; the jitter
                # fills the sub-stratum
                shift = _hash_u32((h + 0x9E3779B9) & _M32) % p
                col = (phi + shift) % p
                sub = (b + _hash_u32(h ^ 0x85EBCA6B) % p) % p
                jit = _u32_to_unit(_hash_u32(
                    h ^ _hash_u32((sample_idx + j) & _M32)))
                # XLA contracts col + x * (1/p) into one fused
                # multiply-add: its single rounding, through float64
                fma = (sub.float() + jit).double() * _inv(p) + col.double()
                out.append(fma.float() * _inv(p))
            return torch.stack(out, -1)

    if kind == "stratified":
        pow2 = spp > 0 and (spp & (spp - 1)) == 0
        salt = _hash_u32((sample_idx + 0x9E3779B9) & _M32)
        out = []
        for c in range(n):
            h = stream_hash(c)
            jitter = _u32_to_unit(_hash_u32(h ^ salt))
            if pow2:
                perm = _kensler_permute_pow2(sample_idx, spp, h)
            else:
                perm = sample_idx % max(spp, 1)
            u = (perm.float() + jitter) * _inv(max(spp, 1))
            # the Cranley-Patterson rotation decorrelates dimensions
            out.append(torch.remainder(u + _u32_to_unit(h), 1.0))
        return torch.stack(out, -1)

    # qmc
    d0, d1 = _sobol_2d(sample_idx)
    return torch.stack([_u32_to_unit((d0 if c % 2 == 0 else d1)
                                     ^ stream_hash(c)) for c in range(n)],
                       -1)
