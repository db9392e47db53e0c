"""kernel_benchmark: the dense-alignment hot ops over problem shapes, timed.

PyTorch port of the JAX package's ``tools/kernel_benchmark.py`` (reference
analogue: sources/tools/kernel_benchmark.cpp:144-228 grid-searches CUDA
launch configurations). The same problem (the synthetic pair, depth 2.0, a
seeded code Jacobian, ``SfmParams(0.3, 2.0, 0.0, 2)``) and the same rows:
  - ``sfm_step`` over a batch B = 1, 2, 4, 8, 16 through
    ``dense_sfm.sfm_step_batch`` (the port's ``jax.vmap(sfm_step)``,
    sampled gradients: ``dense_warp_batch``), and at B = 1 also through
    ``dense_sfm.sfm_step`` (sampled: ``bilinear_warp_planes``);
  - ``se3_step`` at each level's crop (``se3_gram_batch``);
  - ``gaussian_blur_down``, ``sobel_gradients``, ``update_depth``;
  - the fused kernels ``sfm_gram_batch`` and ``se3_gram_batch`` at
    B = 1, 8, 16 over a pool of 5, and ``se3_warp_batch`` at 1. The JAX
    tool skips them at sizes its Pallas tiles do not divide; the port's
    kernels take any size, so every row runs.
Each row is timed by ``common.time_stage``: host ms, CUDA-event µs and the
profiler's kernel µs per call.

Usage: python -m deepfactors_tpu_torch.tools.kernel_benchmark
       [--width 256 --height 192 --cs 32] [--n 20] [--device cpu]
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..config import parse_args
from ..geometry import se3 as se3m
from ..geometry.camera import PinholeCamera
from ..geometry.se3 import SE3
from ..ops import dense_sfm as ds
from ..ops import image as ip
from ..ops.kernels import sfm_error as se
from ..ops.kernels import sfm_gram as sg
from .common import device_from_flag, time_stage

POOL = 5                       # keyframes in the fused kernels' pools


def build_problem(W: int, H: int, CS: int, dev) -> dict:
    """The JAX tool's problem on ``dev``."""
    rng = np.random.RandomState(0)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    img0 = t((0.5 + 0.3 * np.sin(xs / 7) * np.cos(ys / 5)).astype(np.float32))
    img1 = t((0.5 + 0.3 * np.sin(xs / 7 + 0.2) * np.cos(ys / 5))
             .astype(np.float32))
    jac0 = t((0.01 * rng.standard_normal((H, W, CS))).astype(np.float32))
    cam = PinholeCamera.create(fx=0.9 * W, fy=0.9 * W, u0=W / 2, v0=H / 2,
                               width=W, height=H)
    return dict(W=W, H=H, CS=CS, dev=torch.device(dev), img0=img0, img1=img1,
                grad1=ip.sobel_gradients(img1),
                dpt0=torch.full((H, W), 2.0, device=dev),
                std0=torch.zeros((H, W), device=dev), jac0=jac0, cam=cam,
                params=ds.SfmParams(0.3, 2.0, 0.0, 2),
                p0=se3m.identity(device=dev))


def sweep(pr: dict) -> list:
    """The rows: (name, batch, fn) with ``fn()`` computing the row's
    result (a system's JtJ, a Gram stack, a render)."""
    H, W, CS, dev = pr["H"], pr["W"], pr["CS"], pr["dev"]
    img0, img1, grad1, dpt0 = pr["img0"], pr["img1"], pr["grad1"], pr["dpt0"]
    jac0, cam, params, p0 = pr["jac0"], pr["cam"], pr["params"], pr["p0"]
    rows = []

    for B in (1, 2, 4, 8, 16):
        st = lambda x: x.expand((B,) + x.shape).contiguous()  # noqa: E731
        poses = se3m.identity((B,), device=dev)
        args = (poses, poses, torch.zeros((B, CS), device=dev), cam,
                st(img0), st(img1), st(dpt0), st(pr["std0"]), st(jac0),
                st(grad1), params)
        rows.append(("sfm_step (44-dim system)", B,
                     lambda a=args: ds.sfm_step_batch(*a).JtJ))
    rows.append(("sfm_step sampled (one factor)", 1,
                 lambda: ds.sfm_step(p0, p0, torch.zeros(CS, device=dev),
                                     cam, img0, img1, dpt0, pr["std0"], jac0,
                                     grad1, params)[0].JtJ))

    for level, (h, w) in enumerate([(H, W), (H // 2, W // 2),
                                    (H // 4, W // 4)]):
        i0, i1 = img0[:h, :w].contiguous(), img1[:h, :w].contiguous()
        g1 = ip.sobel_gradients(i1)
        d0 = torch.full((h, w), 2.0, device=dev)
        caml = cam.level(level)
        rows.append((f"se3_step level {level}", 1,
                     lambda i0=i0, i1=i1, g1=g1, d0=d0, c=caml:
                     ds.se3_step(p0, c, i0, i1, d0, g1, 0.3).JtJ))

    rows.append(("gaussian_blur_down", 1, lambda: ip.gaussian_blur_down(img0)))
    rows.append(("sobel_gradients", 1, lambda: ip.sobel_gradients(img0)))
    rows.append(("update_depth (code->dpt)", 1,
                 lambda: ip.update_depth(torch.zeros(CS, device=dev),
                                         img0 * 0 + 0.5, jac0, 2.0)))

    # the fused kernels over a pool of POOL keyframes
    imgs = img0.expand(POOL, H, W).contiguous()
    dpts = dpt0.expand(POOL, H, W).contiguous()
    jacT = jac0.permute(2, 0, 1).expand(POOL, CS, H, W).contiguous()
    gxs = grad1[..., 0].expand(POOL, H, W).contiguous()
    gys = grad1[..., 1].expand(POOL, H, W).contiguous()
    for B in (1, 8, 16):
        src = torch.as_tensor(np.arange(B) % POOL, dtype=torch.int32,
                              device=dev)
        dst = torch.as_tensor((np.arange(B) + 1) % POOL, dtype=torch.int32,
                              device=dev)
        kp = sg.make_sfm_params(se3m.identity((B,), device=dev), cam, 2, 0.0,
                                0.3, 2.0)
        rows.append(("sfm_gram_batch", B,
                     lambda kp=kp, s=src, d=dst: sg.sfm_gram_batch(
                         kp, s, d, imgs, dpts, jacT, imgs, gxs, gys)))
        rows.append(("se3_gram_batch", B,
                     lambda kp=kp, s=src, d=dst: sg.se3_gram_batch(
                         kp, s, d, imgs, dpts, imgs, gxs, gys)))
    z = torch.zeros((1,), dtype=torch.int32, device=dev)
    kp1 = sg.make_sfm_params(SE3(p0.q[None], p0.t[None]), cam, 1, 0.0, 0.1,
                             2.0)
    rows.append(("se3_warp_batch", 1,
                 lambda: se.se3_warp_batch(kp1, z, z, imgs[:1], dpts[:1],
                                           imgs[:1])))
    return rows


def main(argv, log=print) -> list:
    """Time every row; returns [{name, batch, host_ms, event_us,
    kernel_us, kernels}]."""
    flags = parse_args(list(argv))
    dev = device_from_flag(flags.get("device", "cuda"))
    W = int(flags.get("width", 256))
    H = int(flags.get("height", 192))
    CS = int(flags.get("cs", 32))
    n = int(flags.get("n", 20))
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    log(f"problem: {W}x{H} CS={CS} on {name}")
    log(f"{'op':<32}{'batch':>6}  per call (host clock; CUDA events; "
        f"profiler kernels)")
    out = []
    for label, B, fn in sweep(build_problem(W, H, CS, dev)):
        t = time_stage(fn, dev, n=n)
        log(f"{label:<32}{B:>6}  {t}")
        out.append(dict(name=label, batch=B, **t._asdict()))
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
    sys.exit(0)
