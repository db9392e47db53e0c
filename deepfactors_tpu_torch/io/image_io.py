"""PNG reading and writing on the standard library (``zlib``, ``struct``).

The JAX package reads and writes frames with OpenCV (``cv2.imread`` /
``cv2.imwrite``); the port's I/O path needs no OpenCV. This module covers
what the drivers and ``save_results`` use:

- reading 8- and 16-bit PNGs of colour types gray, gray + alpha, RGB and
  RGBA (alpha dropped), non-interlaced, with all five row filters; palette
  images and Adam7 interlacing raise;
- ``imread(path, mode)`` with OpenCV's three modes: ``"gray"`` (8-bit gray;
  a colour image through libpng's integer luma, which is what
  ``cv2.imread(path, IMREAD_GRAYSCALE)`` gives, 16-bit samples shifted to 8),
  ``"color"`` (8-bit BGR, ``IMREAD_COLOR``) and ``"any_depth"`` (gray at
  the stored depth, ``IMREAD_ANYDEPTH``; a colour image as ``"gray"``);
- ``imwrite`` of 8-bit gray, 8-bit BGR and 16-bit gray arrays.

JPEG is not decoded here: ``imread`` reads one through ``cv2`` when that is
importable and otherwise raises, naming what is missing (the native loader,
``files-native://``, decodes JPEG through libjpeg).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
# channels per PNG colour type (palette, 3, is not supported)
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
# libpng's rgb_to_gray coefficients for OpenCV's (0.299, 0.587), 15-bit
# fixed point, truncated (png_set_rgb_to_gray): 9797, 19234, 32768 - both
_LUMA_R, _LUMA_G = int(0.299 * 32768), int(0.587 * 32768)
_LUMA_B = 32768 - _LUMA_R - _LUMA_G


def _chunks(data: bytes):
    if data[:8] != _SIG:
        raise IOError("not a PNG file")
    i = 8
    while i + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[i:i + 8])
        yield kind, data[i + 8:i + 8 + n]
        i += 12 + n
        if kind == b"IEND":
            return


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters (PNG spec 9.2): None, Sub, Up, Average,
    Paeth. Returns [h, stride] uint8."""
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != h * (stride + 1):
        raise IOError(f"PNG data holds {rows.size} bytes, expected "
                      f"{h * (stride + 1)}")
    rows = rows.reshape(h, stride + 1)
    ftype, rows = rows[:, 0], rows[:, 1:].astype(np.int64)
    out = np.zeros((h, stride), np.int64)
    prev = np.zeros(stride, np.int64)
    for y in range(h):
        f, cur = int(ftype[y]), rows[y]
        if f == 0:
            line = cur
        elif f == 1:
            # Sub: a running sum along each of the bpp byte lanes
            line = np.cumsum(cur.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif f == 2:
            line = (cur + prev) & 0xFF
        elif f in (3, 4):
            # Average and Paeth depend on the byte just decoded: sequential
            c, u = cur.tolist(), prev.tolist()
            ln = [0] * stride
            for x in range(stride):
                a = ln[x - bpp] if x >= bpp else 0
                if f == 3:
                    pred = (a + u[x]) >> 1
                else:
                    b, cc = u[x], (u[x - bpp] if x >= bpp else 0)
                    p = a + b - cc
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc
                                                            else cc)
                ln[x] = (c[x] + pred) & 0xFF
            line = np.asarray(ln, np.int64)
        else:
            raise IOError(f"PNG row filter {f} is not one of 0-4")
        out[y] = line
        prev = line
    return out.astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """The samples as stored: [H, W] for gray, [H, W, C] in the file's
    channel order (RGB / RGBA / gray + alpha) otherwise; uint8 or uint16."""
    with open(path, "rb") as f:
        data = f.read()
    ihdr, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if ihdr is None:
        raise IOError(f"{path}: PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = ihdr
    if ctype not in _CHANNELS:
        raise IOError(f"{path}: PNG colour type {ctype} (palette) is not "
                      "supported")
    if depth not in (8, 16):
        raise IOError(f"{path}: PNG bit depth {depth} is not supported")
    if interlace:
        raise IOError(f"{path}: interlaced PNG is not supported")
    c = _CHANNELS[ctype]
    bpp = c * depth // 8
    rows = _unfilter(zlib.decompress(b"".join(idat)), h, w * bpp, bpp)
    if depth == 16:
        img = rows.view(">u2").astype(np.uint16)
    else:
        img = rows
    img = img.reshape(h, w, c)
    return img[..., 0] if c == 1 else img


def _gray8_from_rgb(rgb: np.ndarray) -> np.ndarray:
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    return ((_LUMA_R * r + _LUMA_G * g + _LUMA_B * b) >> 15).astype(np.uint8)


def imread(path: str, mode: str = "color") -> np.ndarray:
    """``cv2.imread`` for PNG with mode ``"gray"`` (IMREAD_GRAYSCALE),
    ``"color"`` (IMREAD_COLOR, BGR) or ``"any_depth"`` (IMREAD_ANYDEPTH).
    Raises IOError on a missing or undecodable file."""
    if mode not in ("gray", "color", "any_depth"):
        raise ValueError(f"imread mode {mode!r}")
    with open(path, "rb") as f:
        head = f.read(8)
    if head != _SIG:
        if head[:3] == b"\xff\xd8\xff":
            return _imread_jpeg(path, mode)
        raise IOError(f"{path}: not a PNG file")
    img = read_png(path)
    if img.ndim == 3:
        img = img[..., :3] if img.shape[-1] >= 3 else img[..., 0]
    if mode == "any_depth" and img.ndim == 2:
        return img
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if mode in ("gray", "any_depth"):
        return _gray8_from_rgb(img) if img.ndim == 3 else img
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=-1)
    return img[..., ::-1].copy()


def _imread_jpeg(path: str, mode: str) -> np.ndarray:
    try:
        import cv2
    except ImportError:
        raise IOError(
            f"{path}: reading a JPEG needs cv2 (not importable) or the "
            "native loader's libjpeg (files-native://)") from None
    flag = {"gray": cv2.IMREAD_GRAYSCALE, "color": cv2.IMREAD_COLOR,
            "any_depth": cv2.IMREAD_ANYDEPTH}[mode]
    img = cv2.imread(path, flag)
    if img is None:
        raise IOError(f"{path}: JPEG decode failed")
    return img


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def imwrite(path: str, img: np.ndarray, level: int = 6) -> None:
    """Write [H, W] uint8 / uint16 gray or [H, W, 3] uint8 BGR (OpenCV's
    channel order) as a PNG, filter None on every row."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"imwrite takes uint8 or uint16, not {img.dtype}")
    if img.ndim == 3 and img.shape[-1] == 3 and img.dtype == np.uint8:
        ctype, rows = 2, img[..., ::-1]
    elif img.ndim == 2:
        ctype, rows = 0, img
    else:
        raise ValueError(f"imwrite takes gray or 3-channel BGR, not "
                         f"{img.shape} {img.dtype}")
    h, w = img.shape[:2]
    depth = 16 if img.dtype == np.uint16 else 8
    rows = np.ascontiguousarray(rows, ">u2" if depth == 16 else np.uint8)
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          rows.view(np.uint8).reshape(h, -1)], axis=1)
    with open(path, "wb") as f:
        f.write(_SIG)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                            0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(raw.tobytes(), level)))
        f.write(_chunk(b"IEND", b""))
