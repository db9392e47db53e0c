"""Time the port's one-launch kernels beside an earlier design of the same
kernels, in turns, inside one process on one card.

The current kernels are built from deepfactors_tpu_torch/csrc as always.
``--prev DIR`` names a directory holding earlier sources with the two-launch
C interface of the port's first design (a strip kernel, then a second reduce
kernel), together with the ``sfm_common.cuh`` they include. Every one of
these that DIR holds is built and timed:
  - ``se3_gram.cu`` / ``sfm_gram.cu``: ``se3_gram_launch`` /
    ``sfm_gram_launch`` taking ``part, G, ..., px_per_blk, nblk`` (the
    first design of the two Gram kernels);
  - ``sfm_error.cu``: ``sfm_error_launch(params, src, dst, active, img0,
    dpt, img1, warped, part, out, P, K, K1, H, W, px_per_blk, nblk,
    warp_mode, stream)`` (the first design of sfm_error_batch and
    se3_warp_batch).
With ``--prev``, bilinear_warp_planes is also timed beside its first design,
the committed port_tools/variants/bilinear_warp_first.cu (the kernel of
csrc/dense_warp.cu from commit 2183e17 to 8a9b388: one pixel a thread on
stacked planes). For example, from a commit that holds all three first
designs of the Gram and error kernels (the last one before the Gram
kernels became one launch):

    mkdir -p build/prev && git archive <commit> deepfactors_tpu_torch/csrc \\
        | tar -x -C build/prev --strip-components=2
    python3 port_tools/compare_designs.py --prev build/prev

Shapes are chip_smoke.py's main-path shapes: sfm_gram_batch at P = 128 (64
active), CS 32, depth from the codes, interp gradients, Tukey at 192x256
and Huber at 96x128 and 48x64; se3_gram_batch at P = 1 interp and P = 8
sampled; sfm_error_batch at the keyframe gate (P = 2) and the map dump (P =
64, 32 active); se3_warp_batch at P = 1; bilinear_warp_planes at C = 3 on
stacked planes; each at the three sizes; and at 192x256 the sampling stage
of ``sfm_step`` (the first design: torch.stack of img1 and the two gradient
channels, then its kernel; the port: one launch on the planes in place,
``dense_sfm._sample_img_grad_xy``). Each pair
is timed prev, new, new, prev with chip_smoke.cuda_ms and the readings are
printed with the card's name and power limit, the max difference of the
two designs' outputs, and the time of an empty launch. ``--ptxas`` prints
nvcc's resource report of the current sources; ``--json PATH`` also writes
the readings to PATH.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# source -> (C function, pointer arguments, int arguments) of its first design
PREV_INTERFACES = {"se3_gram": ("se3_gram_launch", 11, 8),
                   "sfm_gram": ("sfm_gram_launch", 13, 11),
                   "sfm_error": ("sfm_error_launch", 10, 8)}


def build_prev(prev_dir, build):
    """{source stem: loaded library} of every first-design source in
    ``prev_dir``, each built by its own nvcc, all started together, and
    {"bilinear_warp_first": its C launcher} from the committed variant."""
    import chip_smoke as cs
    libs = {}
    first_lib = os.path.join(prev_dir, "bilinear_warp_first.so")
    first = cs.start_variant_build(cs.FIRST_BILINEAR_SRC, first_lib)
    procs = []
    for name in PREV_INTERFACES:
        src = os.path.join(prev_dir, f"{name}.cu")
        if not os.path.exists(src):
            continue
        out = os.path.join(prev_dir, f"{name}_prev.so")
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", out, src]
        procs.append((name, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for name, out, proc in procs:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the earlier {name}.cu:\n{text}")
        libs[name] = ctypes.CDLL(out)
        fn_name, nptr, nint = PREV_INTERFACES[name]
        fn = getattr(libs[name], fn_name)
        fn.argtypes = ([ctypes.c_void_p] * nptr + [ctypes.c_int] * nint
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    libs["bilinear_warp_first"] = cs.finish_variant_build(
        first, first_lib, "bilinear_warp_first_launch", 4, 3)
    return libs


def prev_strips(N, max_strips, min_px):
    """The first design's strip split: whole 256-pixel tiles, at least
    ``min_px`` pixels a strip, at most ``max_strips`` strips."""
    per = max(min_px, -(-N // max_strips))
    per = -(-per // 256) * 256
    return per, -(-N // per)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--prev", default=None)
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--json", default=None)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("compare_designs: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from deepfactors_tpu_torch.geometry import se3 as se3m
    from deepfactors_tpu_torch.geometry.camera import camera_pyramid
    from deepfactors_tpu_torch.geometry.se3 import SE3
    from deepfactors_tpu_torch.geometry.warping import depth_to_prox
    from deepfactors_tpu_torch.ops import dense_sfm as ds
    from deepfactors_tpu_torch.ops.kernels import build
    from deepfactors_tpu_torch.ops.kernels import dense_warp as dw
    from deepfactors_tpu_torch.ops.kernels import sfm_error as se
    from deepfactors_tpu_torch.ops.kernels import sfm_gram as sg

    dev = "cuda"
    smi = cs.smi_line()
    cs.log(smi)
    build.build_all(ptxas_verbose=args.ptxas)
    if args.ptxas:
        for src in ("se3_gram.cu", "sfm_gram.cu", "sfm_error.cu",
                    "dense_warp.cu"):
            cs.log(f"--- {src}\n{build.build_log[src]['ptxas']}")
    prev = build_prev(args.prev, build) if args.prev else {}
    p = sg._ptr
    stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def prev_sfm(kp, src, dst, img0, dpt, jac, img1, active, codes, loss):
        P, (K, H, W), CS = src.shape[0], img0.shape, jac.shape[1]
        R = CS + 8
        per, nblk = prev_strips(H * W, 12, 1024)
        part = torch.empty((P, nblk, R * (R + 1) // 2), device=dev)
        G = torch.empty((P, R, R), device=dev)
        code = prev["sfm_gram"].sfm_gram_launch(
            p(kp), p(src), p(dst), p(active), p(codes), p(img0), p(dpt),
            p(jac), p(img1), p(None), p(None), p(part), p(G), P, K,
            img1.shape[0], CS, H, W, per, nblk, 0, sg._LOSSES[loss], 1,
            stream())
        assert code == 0, code
        return G

    def prev_se3(kp, src, dst, img0, dpt, img1, gx, gy, active, gm):
        P, (K, H, W) = src.shape[0], img0.shape
        per, nblk = prev_strips(H * W, 16, 1024)
        part = torch.empty((P, nblk, 36), device=dev)
        G = torch.empty((P, 8, 8), device=dev)
        sampled = gm == "sampled"
        code = prev["se3_gram"].se3_gram_launch(
            p(kp), p(src), p(dst), p(active), p(img0), p(dpt), p(img1),
            p(gx if sampled else None), p(gy if sampled else None), p(part),
            p(G), P, K, img1.shape[0], H, W, per, nblk, int(sampled), stream())
        assert code == 0, code
        return G

    def prev_err(kp, src, dst, img0, dpt, img1, active, warp_mode):
        """(warped or None, residual, inliers) of the first error design."""
        P, (K, H, W) = src.shape[0], img0.shape
        per, nblk = prev_strips(H * W, 48, 1024)
        part = torch.empty((P, nblk, 2), device=dev)
        out = torch.empty((P, 2), device=dev)
        warped = torch.empty((P, H, W), device=dev) if warp_mode else None
        code = prev["sfm_error"].sfm_error_launch(
            p(kp), p(src), p(dst), p(active), p(img0), p(dpt), p(img1),
            p(warped), p(part), p(out), P, K, img1.shape[0], H, W, per, nblk,
            warp_mode, stream())
        assert code == 0, code
        return warped, out[:, 0], out[:, 1]

    def turns(new, old, iters):
        """[prev, new, new, prev] milliseconds (prev None without it)."""
        t = lambda f: cs.cuda_ms(f, iters=iters)
        if old is None:
            return [None, t(new), t(new), None]
        return [t(old), t(new), t(new), t(old)]

    K = 32
    cam, levels, q, t, codes_k = cs.make_pools(dev, K=K, CS=32)
    cams = camera_pyramid(cam, 3)
    rows = []
    floor = cs.cuda_ms(lambda: sg.empty_launch(dev), iters=200)
    cs.log(f"empty launch: {1e3 * floor:.2f} us")
    size = lambda lv: "x".join(map(str, lv["img"].shape[1:]))

    P = 128
    src, dst, active = cs.factor_set(K, P, dev)
    sl, dl = src.long(), dst.long()
    pose_10, _, _ = se3m.relative_pose_jacobians(SE3(q[dl], t[dl]),
                                                 SE3(q[sl], t[sl]))
    pose_10 = cs.perturb(pose_10, seed=3)
    for l, lv in enumerate(levels):
        loss = "tukey" if l == 0 else "huber"
        codes = codes_k[sl].contiguous()
        prx = depth_to_prox(lv["dpt"], 2.0)
        prx0 = (prx - torch.einsum("kchw,kc->khw", lv["jac"], codes_k)).contiguous()
        kp = sg.make_sfm_params(pose_10, cams[l], 2, 0.0,
                                0.1 if loss == "tukey" else 0.3, 2.0)
        new = lambda: sg.sfm_gram_batch(
            kp, src, dst, lv["img"], prx0, lv["jac"], lv["img"], active=active,
            codes=codes, grad_mode="interp", loss=loss)
        old = (lambda: prev_sfm(kp, src, dst, lv["img"], prx0, lv["jac"],
                                lv["img"], active, codes, loss)
               ) if "sfm_gram" in prev else None
        diff = None
        if old:
            a, b = new(), old()
            diff = f"{float((a - b).abs().max() / b.abs().max()):.2e} of max|G|"
        rows.append(dict(kernel="sfm_gram_batch",
                         shape=f"P=128 CS=32 {size(lv)} {loss}",
                         ms=turns(new, old, 20), diff=diff))

    for P, gm in ((1, "interp"), (8, "sampled")):
        src, dst, _ = cs.factor_set(K, P, dev, seed=2)
        active = torch.ones(P, dtype=torch.int32, device=dev)
        sl, dl = src.long(), dst.long()
        pose_10 = cs.perturb(se3m.relative_pose(SE3(q[dl], t[dl]),
                                                SE3(q[sl], t[sl])), seed=4 + P)
        for l, lv in enumerate(levels):
            kp = sg.make_sfm_params(pose_10, cams[l], 1, 0.0, 0.3, 2.0)
            a_ = (kp, src, dst, lv["img"], lv["dpt"], lv["img"], lv["gx"],
                  lv["gy"])
            new = lambda: sg.se3_gram_batch(*a_, active=active, grad_mode=gm)
            old = ((lambda: prev_se3(*a_, active, gm)) if "se3_gram" in prev
                   else None)
            diff = None
            if old:
                a, b = new(), old()
                diff = f"{float((a - b).abs().max() / b.abs().max()):.2e} of max|G|"
            rows.append(dict(kernel="se3_gram_batch",
                             shape=f"P={P} {size(lv)} {gm}",
                             ms=turns(new, old, 100), diff=diff))

    def err_diff(a, b):
        """The two designs' outputs: residual relative, inliers, render."""
        res = float(((a[-2] - b[-2]).abs() / b[-2].abs().clamp(min=1e-12)).max())
        inl = float((a[-1] - b[-1]).abs().max())
        text = f"residual {res:.2e} relative, inliers {inl:.0f} apart"
        if a[0] is not None:
            text += f", render {float((a[0] - b[0]).abs().max()):.2e} abs"
        return text

    for l, lv in enumerate(levels):
        shapes = (("sfm_error_batch", f"gate P=2 {size(lv)}",
                   (cs.gate_case(dev, lv, cams[l], q, t),
                    torch.ones(2, dtype=torch.int32, device=dev))),
                  ("sfm_error_batch", f"dump P=64 (32 active) {size(lv)}",
                   cs.error_case(dev, K, 64, lv, cams[l], q, t)),
                  ("se3_warp_batch", f"P=1 {size(lv)}",
                   cs.error_case(dev, K, 1, lv, cams[l], q, t)))
        for name, shape, (a_, active) in shapes:
            mode = int(name == "se3_warp_batch")
            new = lambda: getattr(se, name)(*a_, active=active)
            old = ((lambda: prev_err(*a_, active, mode)) if "sfm_error" in prev
                   else None)
            diff = None
            if old:
                a, b = new(), old()
                diff = err_diff(a if mode else (None,) + a, b)
            rows.append(dict(kernel=name, shape=shape, ms=turns(new, old, 100),
                             diff=diff))

    def same_bits(a, b):
        nan = torch.isnan(b)
        assert torch.equal(torch.isnan(a), nan) and torch.equal(a[~nan], b[~nan])
        return "nothing (bit-identical, NaN in the same places)"

    for l, lv in enumerate(levels):
        img1, grad1, x1, y1 = cs.bilinear_case(dev, K, lv, cams[l], q, t,
                                               60 + l)
        chans = torch.stack([img1, grad1[..., 0], grad1[..., 1]])
        new = lambda: dw.bilinear_warp_planes(chans, x1, y1)
        old = None
        if prev:
            first = prev["bilinear_warp_first"]
            old = lambda: cs.first_design_kernel(first, chans, x1, y1)
        diff = same_bits(new(), old()) if old else None
        rows.append(dict(kernel="bilinear_warp_planes",
                         shape=f"C=3 {size(lv)}", ms=turns(new, old, 100),
                         diff=diff))
        if l == 0:
            xf, yf = x1.reshape(-1), y1.reshape(-1)
            new = lambda: torch.stack(ds._sample_img_grad_xy(
                img1, grad1, xf, yf, "sampled")).reshape(3, *img1.shape)
            if old:
                old = lambda: cs.first_design_stage(first, img1, grad1, x1, y1)
            diff = same_bits(new(), old()) if old else None
            new = lambda: ds._sample_img_grad_xy(img1, grad1, xf, yf,
                                                 "sampled")
            rows.append(dict(kernel="bilinear_warp_planes",
                             shape=f"sampling stage of sfm_step {size(lv)} "
                             "(prev: torch.stack + kernel; new: one launch)",
                             ms=turns(new, old, 100), diff=diff))

    f = lambda x: "-" if x is None else f"{1e3 * x:.2f}"
    cs.log("times in us, in the order they were taken: prev, new, new, prev")
    for r in rows:
        cs.log(f"{r['kernel']} {r['shape']}: " + " ".join(map(f, r["ms"]))
               + (f"; designs differ by {r['diff']}" if r["diff"] else ""))
    cs.log(smi)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as fh:
            json.dump(dict(card=smi, empty_launch_ms=floor, rows=rows), fh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
