"""test_matching: detect and match features between the first two frames
of a source; print the statistics and save a match image (reference
sources/tools/test_matching.cpp).

PyTorch port of the JAX package's ``tools/test_matching.py``: detection
(``features/detector.detect``), ``features/matching.match`` and
``prune_matches_eight_point`` run on ``--device``. The RANSAC draws come
from a hook of the mapper's form, ``ransac_draw(valids [1, M], iterations)
-> indices [1, I, 8]`` (default: uniform draws from a generator seeded 0),
so that a caller can replay another package's draws. The match image (the
frames side by side, a green line per surviving match) is drawn by
``draw_line``, which sets the pixels ``cv2.line`` sets (LINE_8, thickness
1), and written through ``io/image_io``.

Usage: python -m deepfactors_tpu_torch.tools.test_matching --source <url>
       [--out matches.png] [--nfeatures 200] [--max_dist 64]
       [--ransac_threshold 1e-4] [--device cpu]
"""
from __future__ import annotations

import os
import sys
import tempfile

import numpy as np
import torch

from ..config import parse_args
from ..features import detector as det
from ..features import matching as mt
from ..geometry.camera import PinholeCamera
from ..io import drivers, image_io
from .common import device_from_flag

RANSAC_ITERS = 256      # prune_matches_eight_point's default in the JAX tool


def draw_line(img: np.ndarray, p0, p1, color) -> None:
    """``cv2.line(img, p0, p1, color, 1, cv2.LINE_8)`` for integer end
    points inside ``img`` [H, W, C]: OpenCV's 8-connected Bresenham walk
    (LineIterator), left to right, both end points set."""
    H, W = img.shape[:2]
    (x0, y0), (x1, y1) = (tuple(int(v) for v in p) for p in (p0, p1))
    if not (0 <= x0 < W and 0 <= x1 < W and 0 <= y0 < H and 0 <= y1 < H):
        raise ValueError(f"line ({x0}, {y0}) - ({x1}, {y1}) leaves the "
                         f"{W}x{H} image")
    if x1 < x0:
        x0, y0, x1, y1 = x1, y1, x0, y0
    dx, dy = x1 - x0, y1 - y0
    sx, sy = 1, 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err = dx - 2 * dy
    x, y = x0, y0
    for _ in range(dx + 1):
        img[y, x] = color
        diag = err < 0
        err += -2 * dy + (2 * dx if diag else 0)
        # the major axis moves every step, the minor one when diag
        if vert:
            y += sy
            x += sx if diag else 0
        else:
            x += sx
            y += sy if diag else 0


def match_image(img0, img1, kp0, kp1, ok) -> np.ndarray:
    """The two frames side by side (BGR) with a green line per match."""
    i0 = (np.asarray(img0) * 255).astype(np.uint8)
    i1 = (np.asarray(img1) * 255).astype(np.uint8)
    vis = np.repeat(np.concatenate([i0, i1], axis=1)[..., None], 3, axis=-1)
    for i in np.nonzero(ok)[0]:
        draw_line(vis, (int(kp0[i, 0]), int(kp0[i, 1])),
                  (int(kp1[i, 0]) + i0.shape[1], int(kp1[i, 1])),
                  (0, 255, 0))
    return vis


def main(argv, ransac_draw=None, log=print) -> dict:
    """Detect, match, prune and draw; returns the counts, the inlier mask
    and the matched keypoints (host)."""
    flags = parse_args(list(argv))
    dev = device_from_flag(flags.get("device", "cuda"))
    source = flags.get("source", "synthetic://128x96:5:0.02")
    iface = drivers.get_interface_from_url(source, device=dev)
    fx, fy, u0, v0, W, H = iface.intrinsics()
    cam = PinholeCamera.create(fx=fx, fy=fy, u0=u0, v0=v0, width=W, height=H)
    if ransac_draw is None:
        gen = torch.Generator(device=dev).manual_seed(0)
        ransac_draw = lambda v, n: mt.draw_hypotheses(v, n, gen)  # noqa: E731

    cfg = det.DetectorConfig(max_keypoints=int(flags.get("nfeatures", 200)))
    it = iface.frames()
    f0d = next(it)
    f1d = next(it)
    f0 = det.detect(torch.as_tensor(f0d.img, device=dev), cfg)
    f1 = det.detect(torch.as_tensor(f1d.img, device=dev), cfg)
    m = mt.match(f0.descriptor, f0.valid, f1.descriptor, f1.valid,
                 max_dist=int(flags.get("max_dist", 64)))
    kp0 = f0.xy
    kp1 = f1.xy[m.idx1.long()]
    idx = torch.as_tensor(ransac_draw(m.valid[None], RANSAC_ITERS),
                          device=dev)[0]
    inl = mt.prune_matches_eight_point(
        kp0, kp1, m.valid, cam, idx=idx,
        threshold=float(flags.get("ransac_threshold", 1e-4)))
    ok = (m.valid & inl).cpu().numpy()
    nv = int(m.valid.sum())
    nk = (int(f0.valid.sum()), int(f1.valid.sum()))
    log(f"keypoints: {nk[0]} / {nk[1]}")
    log(f"matches: {nv}  ransac inliers: {int(ok.sum())}")

    out = flags.get("out", os.path.join(tempfile.gettempdir(),
                                        "matches.png"))
    kp0n, kp1n = kp0.cpu().numpy(), kp1.cpu().numpy()
    image_io.imwrite(out, match_image(f0d.img, f1d.img, kp0n, kp1n, ok))
    log(f"wrote {out}")
    return dict(keypoints=nk, matches=nv, inliers=int(ok.sum()), mask=ok,
                kp0=kp0n, kp1=kp1n, out=out)


if __name__ == "__main__":
    main(sys.argv[1:])
    sys.exit(0)
