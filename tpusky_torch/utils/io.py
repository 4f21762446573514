"""Self-contained image / dataset I/O: a copy of the reference package's
`tpusky/utils/io.py` (numpy only; JPEG through PIL, imported where it
is used).

Implements, without external imaging dependencies:

* A reader for the sunsky binary tensor format (magic ``SKY``/``SUN``,
  u32 version, u64 ndim, u64 shape[], raw scalars) used by the reference's
  dataset files (format documented at reference `sunsky.h:515-597`).
* A minimal OpenEXR 2.0 scanline reader (NONE/ZIPS/ZIP compression,
  HALF/FLOAT/UINT channels) and writer (NONE or ZIP, FLOAT channels) —
  sufficient for golden-image tests and render output.
* A reader for ``.spd`` spectrum files (two-column "wavelength value" text).
* PNG, Radiance RGBE (.hdr), PFM and JPEG readers and writers, and
  Mitsuba's binary ``.vol`` grids.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

# ---------------------------------------------------------------------------
# sunsky .bin tensor format
# ---------------------------------------------------------------------------


def read_sunsky_bin(path: str, dtype=np.float64) -> np.ndarray:
    """Read a sunsky dataset tensor (.bin). ``dtype`` is the on-disk scalar
    type (float64 for radiance/params tables, float32 for TGMM tables)."""
    with open(path, "rb") as f:
        magic = f.read(3)
        if magic not in (b"SKY", b"SUN"):
            raise ValueError(f"{path}: bad magic {magic!r}")
        (_version,) = struct.unpack("<I", f.read(4))
        (ndim,) = struct.unpack("<Q", f.read(8))
        shape = struct.unpack(f"<{ndim}Q", f.read(8 * ndim))
        count = int(np.prod(shape))
        data = np.frombuffer(f.read(count * np.dtype(dtype).itemsize), dtype=dtype)
        if data.size != count:
            raise ValueError(f"{path}: truncated data")
    return data.reshape(shape)


# ---------------------------------------------------------------------------
# .spd spectra
# ---------------------------------------------------------------------------


def read_spd(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Read a two-column spectrum file -> (wavelengths, values)."""
    wl, val = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            a, b = line.split()[:2]
            wl.append(float(a))
            val.append(float(b))
    return np.asarray(wl), np.asarray(val)


# ---------------------------------------------------------------------------
# OpenEXR (scanline, subset)
# ---------------------------------------------------------------------------

_PIXEL_DTYPES = {0: np.uint32, 1: np.float16, 2: np.float32}
_COMPRESSION_LINES = {0: 1, 2: 1, 3: 16}  # NONE, ZIPS, ZIP


def _read_cstring(f) -> bytes:
    out = bytearray()
    while True:
        c = f.read(1)
        if c in (b"", b"\x00"):
            return bytes(out)
        out += c


def _unpredict(data: bytes) -> bytes:
    """Invert the EXR deflate pre-filter: delta decode, then de-interleave."""
    t = np.frombuffer(data, np.uint8).astype(np.int64)
    t = (np.cumsum(t - 128) + 128).astype(np.uint8)
    half = (t.size + 1) // 2
    out = np.empty_like(t)
    out[0::2] = t[:half]
    out[1::2] = t[half:]
    return out.tobytes()


def _predict(data: bytes) -> bytes:
    """Apply the EXR deflate pre-filter: interleave, then delta encode."""
    t = np.frombuffer(data, np.uint8)
    half = (t.size + 1) // 2
    inter = np.empty_like(t)
    inter[:half] = t[0::2]
    inter[half:] = t[1::2]
    d = inter.astype(np.int16)
    d[1:] -= inter[:-1].astype(np.int16)
    d[1:] += 128
    return d.astype(np.uint8).tobytes()


def read_exr(path: str) -> tuple[np.ndarray, list[str]]:
    """Read a scanline EXR file.

    Returns (image[h, w, c], channel_names). Channels appear in the file's
    (alphabetical) order. HALF data is widened to float32.
    """
    with open(path, "rb") as f:
        if f.read(4) != b"\x76\x2f\x31\x01":
            raise ValueError(f"{path}: not an EXR file")
        version = struct.unpack("<I", f.read(4))[0]
        if version & 0x200:
            raise ValueError("tiled/deep EXR not supported")

        channels: list[tuple[str, int]] = []
        compression = 0
        data_window = (0, 0, 0, 0)
        while True:
            name = _read_cstring(f)
            if name == b"":
                break
            _attr_type = _read_cstring(f)
            (size,) = struct.unpack("<i", f.read(4))
            value = f.read(size)
            if name == b"channels":
                off = 0
                while off < len(value) - 1:
                    end = value.index(b"\x00", off)
                    ch_name = value[off:end].decode()
                    ptype, _xs, _ys = struct.unpack_from("<i4x2i", value, end + 1)
                    channels.append((ch_name, ptype))
                    off = end + 1 + 16
            elif name == b"compression":
                compression = value[0]
            elif name == b"dataWindow":
                data_window = struct.unpack("<4i", value)

        if compression not in _COMPRESSION_LINES:
            raise ValueError(f"unsupported EXR compression {compression}")

        x_min, y_min, x_max, y_max = data_window
        width = x_max - x_min + 1
        height = y_max - y_min + 1
        lines_per_block = _COMPRESSION_LINES[compression]
        n_blocks = -(-height // lines_per_block)

        f.read(8 * n_blocks)  # chunk offset table; we read sequentially

        bytes_per_px = sum(np.dtype(_PIXEL_DTYPES[pt]).itemsize for _, pt in channels)
        img = {ch: np.zeros((height, width), _PIXEL_DTYPES[pt]) for ch, pt in channels}

        for _ in range(n_blocks):
            y, size = struct.unpack("<2i", f.read(8))
            raw = f.read(size)
            n_lines = min(lines_per_block, y_max - y + 1)
            expect = n_lines * width * bytes_per_px
            if compression != 0 and size < expect:
                raw = _unpredict(zlib.decompress(raw))
            buf, off = raw, 0
            for line in range(n_lines):
                row = y - y_min + line
                for ch, pt in channels:
                    dt = np.dtype(_PIXEL_DTYPES[pt])
                    n = width * dt.itemsize
                    img[ch][row] = np.frombuffer(buf[off:off + n], dt)
                    off += n

    names = [ch for ch, _ in channels]
    stack = np.stack([img[ch].astype(np.float32) for ch in names], axis=-1)
    return stack, names


def write_exr(path: str, image: np.ndarray, channel_names=None,
              compress: bool = True) -> None:
    """Write a float32 scanline EXR. ``image`` is (h, w) or (h, w, c)."""
    image = np.asarray(image, np.float32)
    if image.ndim == 2:
        image = image[..., None]
    h, w, c = image.shape
    if channel_names is None:
        channel_names = (["Y"] if c == 1 else
                         ["R", "G", "B", "A"][:c] if c <= 4 else
                         [f"ch{i:02d}" for i in range(c)])
    # EXR stores channels sorted by name
    order = sorted(range(c), key=lambda i: channel_names[i])

    def attr(name: bytes, atype: bytes, value: bytes) -> bytes:
        return name + b"\x00" + atype + b"\x00" + struct.pack("<i", len(value)) + value

    chan_block = b"".join(
        channel_names[i].encode() + b"\x00" + struct.pack("<i4x2i", 2, 1, 1)
        for i in order) + b"\x00"

    compression = 3 if compress else 0
    lines_per_block = _COMPRESSION_LINES[compression]
    header = b"\x76\x2f\x31\x01" + struct.pack("<I", 2)
    header += attr(b"channels", b"chlist", chan_block)
    header += attr(b"compression", b"compression", bytes([compression]))
    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    header += attr(b"dataWindow", b"box2i", box)
    header += attr(b"displayWindow", b"box2i", box)
    header += attr(b"lineOrder", b"lineOrder", b"\x00")
    header += attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0))
    header += attr(b"screenWindowCenter", b"v2f", struct.pack("<2f", 0, 0))
    header += attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0))
    header += b"\x00"

    blocks = []
    for y0 in range(0, h, lines_per_block):
        n_lines = min(lines_per_block, h - y0)
        payload = b"".join(
            image[y0 + line, :, i].tobytes()
            for line in range(n_lines) for i in order)
        if compress:
            comp = zlib.compress(_predict(payload))
            if len(comp) >= len(payload):
                comp = payload
            payload = comp
        blocks.append(payload)

    with open(path, "wb") as f:
        f.write(header)
        offset = len(header) + 8 * len(blocks)
        for y0, blk in zip(range(0, h, lines_per_block), blocks):
            f.write(struct.pack("<Q", offset))
            offset += 8 + len(blk)
        for y0, blk in zip(range(0, h, lines_per_block), blocks):
            f.write(struct.pack("<2i", y0, len(blk)))
            f.write(blk)


# ---------------------------------------------------------------------------
# PNG (minimal reader/writer — reference `bitmap.cpp` PNG path, H16)
# ---------------------------------------------------------------------------

_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def read_png(path: str) -> np.ndarray:
    """Read a PNG into float32 [0, 1], shape (H, W, C).

    Supports bit depths 8/16, colour types 0 (gray), 2 (RGB), 4 (gray+A),
    6 (RGBA), all five scanline filters; no interlacing, no palette.
    """
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, meta = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        ctype = data[pos + 4:pos + 8]
        chunk = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            w, h, depth, color, comp, filt, interlace = struct.unpack(
                ">IIBBBBB", chunk)
            if interlace:
                raise ValueError("interlaced PNG not supported")
            meta = (w, h, depth, color)
        elif ctype == b"IDAT":
            idat.append(chunk)
        elif ctype == b"IEND":
            break
    if meta is None:
        raise ValueError(f"{path}: missing IHDR")
    w, h, depth, color = meta
    n_chan = {0: 1, 2: 3, 4: 2, 6: 4}.get(color)
    if n_chan is None or depth not in (8, 16):
        raise ValueError(f"unsupported PNG colour type {color}/{depth}-bit")
    raw = zlib.decompress(b"".join(idat))
    bpp = n_chan * depth // 8                    # bytes per pixel
    stride = w * bpp
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros((stride,), np.uint8)
    off = 0
    for y in range(h):
        ftype = raw[off]
        line = np.frombuffer(raw, np.uint8, stride, off + 1).copy()
        off += 1 + stride
        if ftype == 1:      # Sub
            for x in range(bpp, stride):
                line[x] = (line[x] + line[x - bpp]) & 0xFF
        elif ftype == 2:    # Up
            line = (line.astype(np.uint16) + prev) % 256
            line = line.astype(np.uint8)
        elif ftype == 3:    # Average
            for x in range(stride):
                a = line[x - bpp] if x >= bpp else 0
                line[x] = (line[x] + ((int(a) + int(prev[x])) >> 1)) & 0xFF
        elif ftype == 4:    # Paeth
            for x in range(stride):
                a = int(line[x - bpp]) if x >= bpp else 0
                b = int(prev[x])
                c = int(prev[x - bpp]) if x >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pr = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                line[x] = (line[x] + pr) & 0xFF
        out[y] = line
        prev = line
    if depth == 8:
        img = out.reshape(h, w, n_chan).astype(np.float32) / 255.0
    else:
        img = (out.reshape(h, w * n_chan * 2).view(">u2")
               .reshape(h, w, n_chan).astype(np.float32) / 65535.0)
    return img


def write_png(path: str, image: np.ndarray) -> None:
    """Write a float [0,1] (H, W[, C]) image as 8-bit PNG (filter 0)."""
    img = np.asarray(image)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    color = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    u8 = np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8)
    raw = b"".join(b"\x00" + u8[y].tobytes() for y in range(h))

    def chunk(ctype, payload):
        return (struct.pack(">I", len(payload)) + ctype + payload
                + struct.pack(">I", zlib.crc32(ctype + payload)))

    with open(path, "wb") as f:
        f.write(_PNG_SIG)
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color,
                                           0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


# ---------------------------------------------------------------------------
# Radiance RGBE (.hdr) — reference `bitmap.cpp` (FileFormat::RGBE)
# ---------------------------------------------------------------------------

def _float_to_rgbe(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) float -> (H, W, 4) uint8 shared-exponent encoding."""
    img = np.maximum(np.asarray(img, np.float32), 0.0)
    maxc = img.max(axis=-1)
    out = np.zeros(img.shape[:2] + (4,), np.uint8)
    nz = maxc >= 1e-32
    mant, expo = np.frexp(np.where(nz, maxc, 1.0))
    scale = mant * 256.0 / np.where(nz, maxc, 1.0)
    rgb = np.clip(img * scale[..., None], 0, 255).astype(np.uint8)
    out[..., :3] = np.where(nz[..., None], rgb, 0)
    out[..., 3] = np.where(nz, (expo + 128).astype(np.uint8), 0)
    return out


def _rgbe_to_float(rgbe: np.ndarray) -> np.ndarray:
    rgbe = np.asarray(rgbe, np.uint8)
    e = rgbe[..., 3].astype(np.int32)
    scale = np.ldexp(1.0, e - 136)   # 2^(e-128) / 256
    f = rgbe[..., :3].astype(np.float32) * scale[..., None].astype(np.float32)
    return np.where((e > 0)[..., None], f, 0.0).astype(np.float32)


def write_hdr(path: str, image: np.ndarray) -> None:
    """Write a Radiance RGBE `.hdr` file (flat, no RLE — valid per spec)."""
    img = np.asarray(image, np.float32)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError("write_hdr expects (H, W, 3)")
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(_float_to_rgbe(img).tobytes())


def read_hdr(path: str) -> np.ndarray:
    """Read a Radiance `.hdr` file (flat or new-style RLE scanlines)."""
    with open(path, "rb") as f:
        if not f.readline().startswith(b"#?"):
            raise ValueError("not a Radiance file")
        while True:
            line = f.readline()
            if line in (b"\n", b"\r\n"):
                break
            if not line:
                raise ValueError("truncated header")
        dims = f.readline().split()
        if dims[0] != b"-Y" or dims[2] != b"+X":
            raise ValueError(f"unsupported orientation {dims!r}")
        h, w = int(dims[1]), int(dims[3])
        data = f.read()
    out = np.zeros((h, w, 4), np.uint8)
    pos = 0
    for y in range(h):
        # new-style RLE scanline starts 0x02 0x02 hi lo
        if (len(data) - pos >= 4 and data[pos] == 2 and data[pos + 1] == 2
                and ((data[pos + 2] << 8) | data[pos + 3]) == w):
            pos += 4
            for c in range(4):
                x = 0
                while x < w:
                    n = data[pos]; pos += 1
                    if n > 128:      # run
                        out[y, x:x + n - 128, c] = data[pos]
                        pos += 1; x += n - 128
                    else:            # literal
                        out[y, x:x + n, c] = np.frombuffer(
                            data, np.uint8, n, pos)
                        pos += n; x += n
        else:
            row = np.frombuffer(data, np.uint8, w * 4, pos)
            out[y] = row.reshape(w, 4)
            pos += w * 4
    return _rgbe_to_float(out)


# ---------------------------------------------------------------------------
# PFM — reference `bitmap.cpp` (FileFormat::PFM)
# ---------------------------------------------------------------------------

def write_pfm(path: str, image: np.ndarray) -> None:
    """Write a (H, W) or (H, W, 3) float32 PFM (little-endian,
    bottom-up row order per spec)."""
    img = np.asarray(image, np.float32)
    color = img.ndim == 3 and img.shape[2] == 3
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]; color = False
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{w} {h}\n-1.0\n".encode())
        f.write(img[::-1].tobytes())


def read_pfm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        kind = f.readline().strip()
        if kind not in (b"PF", b"Pf"):
            raise ValueError("not a PFM file")
        w, h = map(int, f.readline().split())
        scale = float(f.readline())
        n_chan = 3 if kind == b"PF" else 1
        dt = "<f4" if scale < 0 else ">f4"
        data = np.frombuffer(f.read(w * h * n_chan * 4), dt)
    img = data.reshape(h, w, n_chan)[::-1].astype(np.float32)
    img = img * abs(scale)
    return img if n_chan == 3 else img[..., 0]


# ---------------------------------------------------------------------------
# Mitsuba VOL grid format — reference `src/core/volume.cpp` / gridvolume
# ---------------------------------------------------------------------------

def read_vol(path: str):
    """Read a Mitsuba binary volume file -> (data (Z,Y,X,C) float32,
    bbox_min (3,), bbox_max (3,)). Format (volume docs): magic 'VOL',
    u8 version=3, i32 dtype (1=f32), i32 xres/yres/zres, i32 channels,
    6 x f32 bbox, then xres*yres*zres*channels f32 (x fastest)."""
    import struct
    with open(path, "rb") as f:
        if f.read(3) != b"VOL":
            raise ValueError("not a VOL file")
        version = f.read(1)[0]
        if version != 3:
            raise ValueError(f"unsupported VOL version {version}")
        dtype, xr, yr, zr, ch = struct.unpack("<iiiii", f.read(20))
        if dtype != 1:
            raise ValueError("only float32 VOL supported")
        bbox = struct.unpack("<6f", f.read(24))
        data = np.frombuffer(f.read(xr * yr * zr * ch * 4), "<f4")
    data = data.reshape(zr, yr, xr, ch)
    return (data.astype(np.float32), np.asarray(bbox[:3], np.float32),
            np.asarray(bbox[3:], np.float32))


def write_vol(path: str, data, bbox_min=(0, 0, 0), bbox_max=(1, 1, 1)):
    import struct
    data = np.asarray(data, np.float32)
    if data.ndim == 3:
        data = data[..., None]
    zr, yr, xr, ch = data.shape
    with open(path, "wb") as f:
        f.write(b"VOL" + bytes([3]))
        f.write(struct.pack("<iiiii", 1, xr, yr, zr, ch))
        f.write(struct.pack("<6f", *bbox_min, *bbox_max))
        f.write(data.tobytes())


def write_jpg(path: str, image: np.ndarray, quality: int = 90) -> None:
    """Write an 8-bit JPEG (reference `bitmap.cpp` JPEG branch via
    libjpeg; here via the environment's PIL, the Python-native
    equivalent). Float input is treated as linear radiance, gamma-encoded
    to sRGB and clipped — same convention as `write_png`."""
    from PIL import Image
    img = np.asarray(image)
    if img.dtype in (np.float32, np.float64):
        img = np.clip(img, 0.0, 1.0)
        srgb = np.where(img <= 0.0031308, img * 12.92,
                        1.055 * img ** (1 / 2.4) - 0.055)
        img = (srgb * 255.0 + 0.5).astype(np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[-1] == 1:
        pil = Image.fromarray(img[..., 0], mode="L")
    else:
        pil = Image.fromarray(img[..., :3], mode="RGB")
    pil.save(path, format="JPEG", quality=int(quality))


def read_jpg(path: str) -> np.ndarray:
    """Read a JPEG -> float32 linear RGB in [0, 1] (inverse of
    `write_jpg`'s sRGB encoding)."""
    from PIL import Image
    with Image.open(path) as pil:
        arr = np.asarray(pil.convert("RGB"), np.float32) / 255.0
    return np.where(arr <= 0.04045, arr / 12.92,
                    ((arr + 0.055) / 1.055) ** 2.4).astype(np.float32)
