"""The port's PNG codec (deepfactors_tpu_torch/io/image_io.py) against
OpenCV, which the JAX package reads and writes frames with.

Everything here is exact: a PNG is lossless, so a decoded array must equal
``cv2.imread``'s in each mode (gray, colour, any depth) element for
element, and a written one must read back (by the port and by OpenCV) as
the array written. Files come from ``cv2.imwrite`` (its own filter choice)
and from an encoder in this file that writes every row with one given
filter type (None, Sub, Up, Average, Paeth), so each of the five filters is
decoded at least once for each of 8-bit gray, 8-bit colour, 8-bit colour
with alpha and 16-bit gray.
"""
import struct
import sys
import zlib

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from deepfactors_tpu_torch.io import image_io  # noqa: E402

torch.set_num_threads(2)

MODES = {"gray": cv2.IMREAD_GRAYSCALE, "color": cv2.IMREAD_COLOR,
         "any_depth": cv2.IMREAD_ANYDEPTH}


def _arrays(seed=0, h=13, w=17):
    rng = np.random.RandomState(seed)
    ys, xs = np.mgrid[0:h, 0:w]
    smooth = (127 + 90 * np.sin(xs / 3.0) * np.cos(ys / 2.0)).astype(np.uint8)
    return {"gray8": rng.randint(0, 256, (h, w)).astype(np.uint8),
            "smooth8": smooth,
            "bgr8": rng.randint(0, 256, (h, w, 3)).astype(np.uint8),
            "gray16": rng.randint(0, 65536, (h, w)).astype(np.uint16)}


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _encode(path, rows: np.ndarray, depth: int, ctype: int, ftype: int):
    """A PNG whose every row carries filter ``ftype``; ``rows`` is [h,
    stride] of the raw (big-endian) bytes."""
    h, stride = rows.shape
    bpp = {0: 1, 2: 3, 4: 2, 6: 4}[ctype] * depth // 8
    out = bytearray()
    prev = [0] * stride
    for y in range(h):
        cur = rows[y].tolist()
        line = [ftype]
        for x in range(stride):
            a = cur[x - bpp] if x >= bpp else 0
            b = prev[x]
            c = prev[x - bpp] if x >= bpp else 0
            pred = (0, a, b, (a + b) >> 1, _paeth(a, b, c))[ftype]
            line.append((cur[x] - pred) & 0xFF)
        out += bytes(line)
        prev = cur
    w = stride // bpp

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                           0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(bytes(out))))
        f.write(chunk(b"IEND", b""))


def _raw_rows(a: np.ndarray, depth: int) -> np.ndarray:
    h = a.shape[0]
    if a.ndim == 3:
        a = a[..., [2, 1, 0, 3][:a.shape[-1]]]      # BGR(A) -> RGB(A)
    return np.ascontiguousarray(a, ">u2" if depth == 16 else np.uint8) \
        .view(np.uint8).reshape(h, -1)


@pytest.mark.parametrize("name", ["gray8", "smooth8", "bgr8", "gray16"])
def test_reads_cv2_written_files(tmp_path, name):
    a = _arrays()[name]
    p = str(tmp_path / f"{name}.png")
    cv2.imwrite(p, a)
    for mode, flag in MODES.items():
        ours, ref = image_io.imread(p, mode), cv2.imread(p, flag)
        assert ours.dtype == ref.dtype and ours.shape == ref.shape, mode
        np.testing.assert_array_equal(ours, ref, err_msg=mode)


@pytest.mark.parametrize("name", ["gray8", "bgr8", "gray16"])
def test_round_trip(tmp_path, name):
    a = _arrays(1)[name]
    p = str(tmp_path / f"{name}.png")
    image_io.imwrite(p, a)
    np.testing.assert_array_equal(cv2.imread(p, cv2.IMREAD_UNCHANGED), a)
    back = image_io.imread(p, "color" if a.ndim == 3 else "any_depth")
    assert back.dtype == a.dtype
    np.testing.assert_array_equal(back, a)
    np.testing.assert_array_equal(image_io.read_png(p),
                                  a[..., ::-1] if a.ndim == 3 else a)


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_every_row_filter(tmp_path, ftype):
    arrs = _arrays(2 + ftype)
    bgra = np.concatenate([arrs["bgr8"], arrs["gray8"][..., None]], -1)
    cases = [("gray8", arrs["smooth8"], 8, 0), ("bgr8", arrs["bgr8"], 8, 2),
             ("bgra8", bgra, 8, 6), ("gray16", arrs["gray16"], 16, 0)]
    for name, a, depth, ctype in cases:
        p = str(tmp_path / f"{name}_{ftype}.png")
        _encode(p, _raw_rows(a, depth), depth, ctype, ftype)
        for mode, flag in MODES.items():
            ours, ref = image_io.imread(p, mode), cv2.imread(p, flag)
            np.testing.assert_array_equal(ours, ref,
                                          err_msg=f"{name} {mode}")
        np.testing.assert_array_equal(
            image_io.read_png(p),
            a[..., [2, 1, 0, 3]] if ctype == 6 else
            a[..., ::-1] if a.ndim == 3 else a)


def test_unsupported_and_errors(tmp_path, monkeypatch):
    p = str(tmp_path / "x.txt")
    with open(p, "wb") as f:
        f.write(b"not an image at all")
    with pytest.raises(IOError):
        image_io.imread(p)
    with pytest.raises(IOError):
        image_io.imread(str(tmp_path / "missing.png"))
    with pytest.raises(ValueError):
        image_io.imwrite(str(tmp_path / "f.png"), np.zeros((4, 4), np.float32))
    # interlaced: the IHDR's last byte
    q = str(tmp_path / "i.png")
    image_io.imwrite(q, np.zeros((4, 4), np.uint8))
    data = bytearray(open(q, "rb").read())
    data[28] = 1
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
    open(q, "wb").write(bytes(data))
    with pytest.raises(IOError, match="interlaced"):
        image_io.read_png(q)
    # JPEG goes through cv2 where it imports, else names what is missing
    j = str(tmp_path / "f.jpg")
    cv2.imwrite(j, _arrays()["bgr8"])
    np.testing.assert_array_equal(image_io.imread(j, "gray"),
                                  cv2.imread(j, cv2.IMREAD_GRAYSCALE))
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(IOError, match="cv2"):
        image_io.imread(j, "gray")
