"""decode_image: decode one image with the zero code and with the
predicted code, timed (reference sources/tools/decode_image.cpp;
``--ntests`` like its flag).

PyTorch port of the JAX package's ``tools/decode_image.py``. The network
is loaded by ``models/decoder.load_decoder`` from ``--network`` (a prefix
of ``.json`` + ``.pkl``; default ``data/nets/room256_32v4``, 192x256,
CS 32). Each decode is timed over ``--ntests`` back-to-back calls on the
host clock (ending in a synchronise) and, on the card, with CUDA events
and the profiler's kernel sum; all are printed. Writes ``input.png``,
``depth_zero_code.png`` and ``depth_predicted_code.png``
(``viz.apply_colormap``, BGR) into ``--out``.
A file input is read through ``io/image_io`` and resized by
``io/preprocess.resize_bilinear`` (OpenCV's bilinear resize of the float
image; the JAX tool resizes the 8-bit image).

Usage: python -m deepfactors_tpu_torch.tools.decode_image
       <image-or-'synthetic'> [--ntests N] [--network PREFIX] [--out dir]
       [--device cpu]
"""
from __future__ import annotations

import os
import sys
import tempfile

import numpy as np
import torch

from ..config import parse_args
from ..geometry import warping as wp
from ..io import image_io
from ..io.preprocess import resize_bilinear
from ..models.decoder import load_decoder
from ..viz import apply_colormap
from .bench_config import DECODER
from .common import device_from_flag, time_stage


def main(argv, log=print) -> dict:
    """Decode, time and write; returns the times (``common.StageTime`` as
    dicts), the predicted code and both level-0 proximity maps (host)."""
    flags = parse_args(list(argv))
    dev = device_from_flag(flags.get("device", "cuda"))
    pos = flags.get("__positional__", [])
    src = pos[0] if pos else "synthetic"
    ntests = int(flags.get("ntests", 10))
    out = flags.get("out", os.path.join(tempfile.gettempdir(),
                                        "decode_image"))
    dec = load_decoder(flags.get("network", DECODER), device=dev)
    cfg = dec.cfg

    if src == "synthetic":
        ys, xs = np.mgrid[0:cfg.input_height,
                          0:cfg.input_width].astype(np.float32)
        img = (0.5 + 0.3 * np.sin(xs / 9) * np.cos(ys / 7)).astype(np.float32)
    else:
        img = image_io.imread(src, "gray").astype(np.float32) / 255.0
        img = resize_bilinear(img, cfg.input_width, cfg.input_height)
    img = torch.as_tensor(img, device=dev)
    zero = torch.zeros(cfg.code_size, device=dev)

    # zero-code decode (with the Jacobians, like ut_decoder DecodeZero)
    t_zero = time_stage(lambda: dec.decode(img, zero), dev, n=ntests,
                        warmup=1)
    log(f"decode (zero code + jacobians): {t_zero} (avg of {ntests})")
    t_pred = time_stage(lambda: dec.predict_and_decode(img), dev, n=ntests,
                        warmup=1)
    log(f"predict_and_decode: {t_pred} (avg of {ntests})")
    r = dec.decode(img, zero)
    rp = dec.predict_and_decode(img)
    code = rp.code.cpu().numpy()
    log(f"predicted code[:8]: {code[:8]}")

    os.makedirs(out, exist_ok=True)
    dpt0 = wp.prox_to_depth(torch.clamp(r.prx[0], 0.01, 0.99),
                            cfg.avg_dpt).cpu().numpy()
    dptp = wp.prox_to_depth(torch.clamp(rp.prx[0], 0.01, 0.99),
                            cfg.avg_dpt).cpu().numpy()
    image_io.imwrite(os.path.join(out, "input.png"),
                     (img.cpu().numpy() * 255).astype(np.uint8))
    image_io.imwrite(os.path.join(out, "depth_zero_code.png"),
                     apply_colormap(dpt0)[..., ::-1])
    image_io.imwrite(os.path.join(out, "depth_predicted_code.png"),
                     apply_colormap(dptp)[..., ::-1])
    log(f"wrote {out}/")
    return dict(zero=t_zero._asdict(), predicted=t_pred._asdict(), code=code,
                prx_zero=r.prx[0].cpu().numpy(),
                prx_predicted=rp.prx[0].cpu().numpy(), out=out)


if __name__ == "__main__":
    main(sys.argv[1:])
    sys.exit(0)
