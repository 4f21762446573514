"""The port's image, volume and dataset files (`tpusky_torch/utils/io.py`)
against the JAX package's `tpusky/utils/io.py` on the CPU: every format
round-trips through the port as tests/test_io.py's cases do, and each
package's writer is read by the other's reader bitwise (the two writers
write the same bytes).

At most 3 items, so that pytest-xdist's `--dist loadfile` hands this
file out after tests/test_multihost.py.
"""

import os
import struct

import numpy as np
import torch

from tpusky.utils import io as JIO
from tpusky_torch.utils import io as TIO

torch.set_num_threads(1)


def _images():
    """{format: image} of tests/test_io.py's cases."""
    rng = np.random.default_rng(0)
    h, w = 32, 48
    ys = np.linspace(0, 1, h)[:, None]
    xs = np.linspace(0, 1, w)[None, :]
    smooth = np.stack([0.2 + 0.6 * ys * np.ones_like(xs),
                       0.1 + 0.5 * xs * np.ones_like(ys),
                       0.4 * np.ones((h, w))], -1).astype(np.float32)
    return {
        "exr": rng.standard_normal((37, 53, 3)).astype(np.float32),
        "exr10": rng.standard_normal((16, 16, 10)).astype(np.float32),
        "exr_raw": np.arange(12, dtype=np.float32).reshape(3, 4),
        "hdr": (rng.uniform(0, 1, (17, 23, 3)) ** 2 * 50).astype(np.float32),
        "pfm": rng.normal(size=(9, 13, 3)).astype(np.float32),
        "pfm_gray": rng.normal(size=(5, 7)).astype(np.float32),
        "png": rng.uniform(0, 1, (11, 7, 3)).astype(np.float32),
        "png_gray": rng.uniform(0, 1, (6, 9)).astype(np.float32),
        "jpg": smooth,
        "vol": rng.random((3, 4, 5, 2)).astype(np.float32),
    }


def _write(io, fmt, path, img):
    if fmt == "exr":
        io.write_exr(path, img, ["R", "G", "B"])
    elif fmt == "exr10":
        io.write_exr(path, img, [f"ch{i:02d}" for i in range(10)])
    elif fmt == "exr_raw":
        io.write_exr(path, img, compress=False)
    elif fmt == "hdr":
        io.write_hdr(path, img)
    elif fmt.startswith("pfm"):
        io.write_pfm(path, img)
    elif fmt.startswith("png"):
        io.write_png(path, img)
    elif fmt == "jpg":
        io.write_jpg(path, img, quality=95)
    else:
        io.write_vol(path, img, (-1.0, -2.0, -3.0), (1.0, 2.0, 3.0))


def _read(io, fmt, path):
    if fmt.startswith("exr"):
        img, names = io.read_exr(path)
        return img, names
    if fmt == "hdr":
        return io.read_hdr(path)
    if fmt.startswith("pfm"):
        return io.read_pfm(path)
    if fmt.startswith("png"):
        return io.read_png(path)
    if fmt == "jpg":
        return io.read_jpg(path)
    return io.read_vol(path)


def _ext(fmt):
    return "." + fmt.split("_")[0].replace("exr10", "exr")


def test_port_formats_roundtrip(tmp_path):
    """tests/test_io.py's round trips through the port: EXR bitwise (RGB,
    10 named channels, uncompressed), RGBE within 1% of a pixel's peak
    with exact zeros, PFM bitwise (colour and gray), PNG to the nearest
    8-bit level, JPEG within 0.02 mean and 0.12 max, VOL bitwise with its
    box; `read_spd` and `read_sunsky_bin` on files written here."""
    imgs = _images()
    imgs["hdr"][3, 4] = 0.0
    for fmt, img in imgs.items():
        path = str(tmp_path / f"t_{fmt}{_ext(fmt)}")
        _write(TIO, fmt, path, img)
        back = _read(TIO, fmt, path)
        if fmt == "exr":
            assert sorted(back[1]) == ["B", "G", "R"]
            assert np.array_equal(back[0][..., ::-1], img)
        elif fmt == "exr10":
            assert back[1] == [f"ch{i:02d}" for i in range(10)]
            assert np.array_equal(back[0], img)
        elif fmt == "exr_raw":
            assert np.array_equal(back[0][..., 0], img)
        elif fmt == "hdr":
            assert back.shape == img.shape and np.all(back[3, 4] == 0.0)
            rel = np.abs(back - img) / np.maximum(
                img.max(axis=-1, keepdims=True), 1e-9)
            assert rel.max() < 0.01, rel.max()
        elif fmt.startswith("pfm"):
            np.testing.assert_array_equal(back, img)
        elif fmt.startswith("png"):
            want = np.round(img * 255.0) / 255.0
            want = want if want.ndim == 3 else want[..., None]
            np.testing.assert_allclose(back, want, atol=1e-7)
        elif fmt == "jpg":
            assert back.shape == img.shape and back.dtype == np.float32
            assert np.abs(back - img).mean() < 0.02
            assert np.abs(back - img).max() < 0.12
        else:
            data, lo, hi = back
            np.testing.assert_array_equal(data, img)
            np.testing.assert_array_equal(lo, [-1, -2, -3])
            np.testing.assert_array_equal(hi, [1, 2, 3])
    spd = tmp_path / "s.spd"
    spd.write_text("# wavelength value\n400 0.25\n500 0.5\n\n600 1.0\n")
    for io in (TIO, JIO):
        wl, val = io.read_spd(str(spd))
        np.testing.assert_array_equal(wl, [400, 500, 600])
        np.testing.assert_array_equal(val, [0.25, 0.5, 1.0])
    table = np.random.default_rng(3).random((2, 3, 4))
    for magic, dt in ((b"SKY", np.float64), (b"SUN", np.float32)):
        path = tmp_path / f"t_{magic.decode()}.bin"
        path.write_bytes(magic + struct.pack("<IQ3Q", 1, 3, 2, 3, 4)
                         + table.astype(dt).tobytes())
        got = TIO.read_sunsky_bin(str(path), dt)
        np.testing.assert_array_equal(got, table.astype(dt))
        np.testing.assert_array_equal(
            got, JIO.read_sunsky_bin(str(path), dt))


def test_writers_read_across_packages(tmp_path):
    """Each package's writer, the other's reader: the files are the same
    bytes, and what each reader returns is bitwise what the other
    returns, for every format (VOL in both directions)."""
    for fmt, img in _images().items():
        paths = {}
        for tag, io in (("port", TIO), ("ref", JIO)):
            paths[tag] = str(tmp_path / f"{tag}_{fmt}{_ext(fmt)}")
            _write(io, fmt, paths[tag], img)
        with open(paths["port"], "rb") as a, open(paths["ref"], "rb") as b:
            assert a.read() == b.read(), fmt
        for src in ("port", "ref"):
            got_t = _read(TIO, fmt, paths[src])
            got_j = _read(JIO, fmt, paths[src])
            for x, y in zip(got_t if isinstance(got_t, tuple) else (got_t,),
                            got_j if isinstance(got_j, tuple) else (got_j,)):
                if isinstance(x, list):
                    assert x == y, fmt
                else:
                    assert np.asarray(x).dtype == np.asarray(y).dtype, fmt
                    np.testing.assert_array_equal(x, y, err_msg=fmt)
    assert os.path.getsize(paths["port"]) > 0
