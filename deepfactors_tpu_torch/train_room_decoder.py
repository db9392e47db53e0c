"""Train the depth decoder on the procedural indoor-room distribution, on
the card: the PyTorch port of ``tools/train_room_decoder.py`` (its flags,
its dataset draws, its optimiser and its outputs).

The whole dataset is rendered into one device tensor (``io/synth.render``
over chunks of 8 poses), batches are gathered on the device, the
photometric augmentation runs on the device, and the loss is read on the
host only every ``--log-every`` steps. Every random draw of training comes
from one ``torch.Generator`` on the device (seeded 0); the dataset's poses
come from ``np.random.RandomState`` in the JAX tool's order, so the same
seed renders the JAX tool's views.

Writes ``<out>.pkl`` (the decoder's parameters in the JAX layout, which
both packages load) and ``<out>.json`` (the network config with the JAX
tool's keys and the held-out depth RMSEs), and ``<out>.ckpt.pkl`` every
4000 steps.

    python -m deepfactors_tpu_torch.train_room_decoder --steps 36000 \\
        --rooms 144 --poses-per-room 28 --randomize --pred-head conv \\
        --out data/nets/room256_32v5

``--device`` defaults to cuda and stops without a card; ``--device cpu``
runs on the CPU.

Data-parallel over the ranks of a ``torch.distributed`` world (the JAX
``train(mesh=)``), started by ``torchrun``:

    torchrun --nproc-per-node N -m deepfactors_tpu_torch.train_room_decoder \
        --distributed [flags]

Every rank renders the dataset on its own card, draws every batch index,
augmentation and noise of the whole batch from its generator (seeded
alike), steps on its rows (``--batch`` must divide by N) and averages the
gradients over the world (``models.train_decoder.make_train_step``), so
the ranks hold the same parameters at every step; the run checks that they
are bit-identical at its end. Only rank 0 evaluates and writes files.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

H, W, CS, LEVELS = 192, 256, 32, 3
AVG_DPT = 2.0
FOCAL = 220.0
CHUNK = 8
CKPT_EVERY = 4000
BLUR_K3 = np.array([[1, 2, 1], [2, 4, 2], [1, 2, 1]], np.float32) / 16.0
# strong = the real-imagery tier (widest photometric randomization); mild
# = the balanced tier (the JAX tool's two settings)
AUG = {"strong": dict(gamma=(0.6, 1.7), gain=(0.7, 1.25), bias=0.12,
                      ramp=0.25, vig=0.35, noise=0.03, blur_p=0.3),
       "mild": dict(gamma=(0.75, 1.4), gain=(0.8, 1.2), bias=0.08,
                    ramp=0.15, vig=0.25, noise=0.02, blur_p=0.2)}


def build_dataset(rooms, poses_per_room, height, width, cam, seed=0,
                  n_boxes=3, randomize=False, scale_range=(0.75, 2.2),
                  device="cuda"):
    """Render [rooms * poses_per_room, H, W] images and z-depths on
    ``device`` (plain 1x renders, 8 poses a call), in the JAX tool's draw
    order. ``randomize`` is its domain-randomisation tier: per room 0-5
    boxes, texture frequency scale 0.7-1.3, room size scale from
    ``scale_range``, a camera radius of 1.5 x the size scale and camera
    roll up to 0.25 rad."""
    from .geometry.se3 import SE3
    from .io import synth

    rng = np.random.RandomState(seed)

    def random_poses(n, r_max=1.2, roll_amp=0.0):
        qs, ts = [], []
        for _ in range(n):
            r = rng.uniform(0.0, r_max)
            th = rng.uniform(0, 2 * np.pi)
            ts.append([r * np.cos(th), rng.uniform(-0.25, 0.25),
                       r * np.sin(th)])
            q = synth._np_yaw_pitch_quat(rng.uniform(0, 2 * np.pi),
                                         rng.uniform(-0.25, 0.25))
            if roll_amp > 0.0:
                # compose a roll about the camera z axis: q * (cr, 0, 0, sr)
                half = 0.5 * rng.uniform(-roll_amp, roll_amp)
                cr, sr = np.cos(half), np.sin(half)
                w, x, y, z = q
                q = np.array([w * cr - z * sr, x * cr - y * sr,
                              y * cr + x * sr, z * cr + w * sr], q.dtype)
            qs.append(q)
        return np.stack(qs), np.asarray(ts, np.float32)

    n = rooms * poses_per_room
    imgs = torch.empty((n, height, width), device=device)
    dpts = torch.empty((n, height, width), device=device)
    at = 0
    for r in range(rooms):
        if randomize:
            nb = int(rng.randint(0, 6))
            fs = float(rng.uniform(0.7, 1.3))
            ss = float(rng.uniform(*scale_range))
            sc = synth.random_room(seed * 7919 + r, nb, freq_scale=fs,
                                   size_scale=ss)
            q, t = random_poses(poses_per_room, r_max=1.5 * ss,
                                roll_amp=0.25)
        else:
            sc = synth.random_room(seed * 7919 + r, n_boxes)
            q, t = random_poses(poses_per_room)
        for c in range(0, poses_per_room, CHUNK):
            im, dp = synth.render(sc, cam, SE3(q[c:c + CHUNK], t[c:c + CHUNK]),
                                  height, width, device=device)
            imgs[at:at + len(im)] = im
            dpts[at:at + len(im)] = dp
            at += len(im)
    return imgs, dpts


def apply_augment(imgs, vals, noise, blur_on):
    """The JAX tool's photometric randomisation of [B, H, W] images in
    [0, 1] with given draws: ``vals`` [B, 7] the uniforms (gamma, gain,
    bias, x ramp, y ramp, vignette, noise amplitude) in their ranges,
    ``noise`` [B, H, W] unit normals, ``blur_on`` [B] bools."""
    from .ops import image as ip

    Hh, Ww = imgs.shape[-2:]
    gy, gx = np.mgrid[0:Hh, 0:Ww]
    ys = torch.as_tensor((gy / (Hh - 1) - 0.5) * 2, dtype=torch.float32,
                         device=imgs.device)
    xs = torch.as_tensor((gx / (Ww - 1) - 0.5) * 2, dtype=torch.float32,
                         device=imgs.device)
    r2 = xs ** 2 + ys ** 2
    v = [vals[:, i, None, None] for i in range(7)]
    img = imgs.clamp(1e-3, 1.0) ** v[0]
    ramp = v[3] * xs + v[4] * ys                      # illumination
    vig = 1.0 - v[5] * r2                             # vignette
    img = (img * v[1] + v[2] + ramp) * vig
    img = img + v[6] * noise                          # sensor noise
    blur = ip._conv2d_clamped(img, BLUR_K3)
    img = torch.where(blur_on[:, None, None], blur, img)
    return img.clamp(0.0, 1.0)


def make_augment(strength="mild"):
    """``augment(imgs [B, H, W], generator) -> imgs``: draws each sample's
    seven uniforms, a noise field and the blur coin from ``generator``,
    then ``apply_augment``. Applied to the training batch only. A rank of
    a data-parallel world passes ``batch`` (the whole batch's size) and
    ``rows`` (its rows of it, which imgs holds): the draws are made for the
    whole batch and its rows taken, as one process draws them."""
    A = AUG[strength]
    lo = [A["gamma"][0], A["gain"][0], -A["bias"], -A["ramp"], -A["ramp"],
          0.0, 0.0]
    hi = [A["gamma"][1], A["gain"][1], A["bias"], A["ramp"], A["ramp"],
          A["vig"], A["noise"]]

    def augment(imgs, generator, batch=None, rows=slice(None)):
        B, dev = batch or imgs.shape[0], imgs.device
        lo_t = torch.tensor(lo, device=dev)
        hi_t = torch.tensor(hi, device=dev)
        u = torch.rand((B, 7), generator=generator, device=dev)
        noise = torch.randn((B,) + imgs.shape[1:], generator=generator,
                            device=dev)
        blur_on = torch.rand((B,), generator=generator,
                             device=dev) < A["blur_p"]
        return apply_augment(imgs, (lo_t + u * (hi_t - lo_t))[rows],
                             noise[rows], blur_on[rows])

    return augment


def evaluate(decoder, imgs, dpts, chunk=8):
    """Held-out depth quality of a ``models.decoder.Decoder`` on [N, H, W]
    images and depths: per frame the depth RMSE at the zero code, the
    predicted code and the optimal code (the ridge least-squares fit of
    the code to the true proximity, code prior sigma 1: the best BA can
    reach with this decoder), the prox RMSE at the zero and predicted
    codes, and the rms of both codes. Returns the mean of each of the
    seven over the frames, in the JAX tool's order."""
    from .geometry import warping as wp

    stats = []
    with torch.no_grad():
        for s in range(0, imgs.shape[0], chunk):
            img, dpt = imgs[s:s + chunk], dpts[s:s + chunk]
            out = decoder.module(img)
            prx_gt = wp.depth_to_prox(dpt, decoder.cfg.avg_dpt)
            prx0, jac, code = out["prx0"][0], out["jac"][0], out["code_pred"]
            B, C = jac.shape[:2]
            J = jac.reshape(B, C, -1)                        # [B, CS, HW]
            r = (prx_gt - prx0).reshape(B, -1, 1)
            A = J @ J.mT + torch.eye(C, device=J.device)
            code_opt = torch.linalg.solve(A, J @ r)[..., 0]
            prx_p = prx0 + torch.einsum("bchw,bc->bhw", jac, code)
            prx_o = prx0 + (code_opt[:, None] @ J)[:, 0].reshape(prx0.shape)

            def depth(p):
                return wp.prox_to_depth(p.clamp(1e-4, 1 - 1e-4),
                                        decoder.cfg.avg_dpt)

            rms = lambda x: x.square().mean(dim=tuple(range(1, x.dim()))).sqrt()
            stats.append(torch.stack([
                rms(depth(prx0) - dpt), rms(depth(prx_p) - dpt),
                rms(prx0 - prx_gt), rms(prx_p - prx_gt), rms(code),
                rms(depth(prx_o) - dpt), rms(code_opt)], dim=1))
    return torch.cat(stats).mean(0).cpu().numpy()


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="train_room_decoder")
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--rooms", type=int, default=56)
    ap.add_argument("--val-rooms", type=int, default=8)
    ap.add_argument("--poses-per-room", type=int, default=48)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--beta", type=float, default=3e-4)
    ap.add_argument("--base-ch", type=int, default=32)
    ap.add_argument("--pred-head", default="gap", choices=("gap", "conv"))
    ap.add_argument("--distill-w", type=float, default=0.1)
    ap.add_argument("--out", default="data/nets/room256_32")
    ap.add_argument("--log-every", type=int, default=200)
    ap.add_argument("--aug-strength", default="mild",
                    choices=("mild", "strong"))
    ap.add_argument("--randomize", action="store_true",
                    help="domain randomization: varied geometry/texture "
                         "scale/camera roll + photometric augmentation of "
                         "the decoder input")
    ap.add_argument("--scale-lo", type=float, default=0.75,
                    help="room size_scale randomization lower bound")
    ap.add_argument("--scale-hi", type=float, default=2.2,
                    help="room size_scale randomization upper bound")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--distributed", action="store_true",
                    help="data-parallel over the ranks that torchrun "
                         "started (a card a rank)")
    return ap.parse_args(argv)


def main(argv=None, log=print) -> dict:
    """Train, evaluate and write the weights; returns a summary: the nll
    of every step, the loss of each logged step, the step times (ms; CUDA
    events between steps on the card, the host clock on the CPU), the peak
    device memory of training (bytes, the card only), the held-out means
    and the paths written. With ``--distributed`` also this process's rank
    and the world size; a rank other than 0 returns before evaluating
    (``val`` None) and writes nothing."""
    from . import configure_numerics
    from .geometry import warping as wp
    from .geometry.camera import PinholeCamera
    from .models.decoder import (Decoder, NetworkConfig, init_flax_defaults,
                                 save_params)
    from .models.train_decoder import (OptaxAdam, VAEModel,
                                       cosine_decay_schedule,
                                       extract_decoder_params,
                                       make_train_step)
    from .parallel import multihost

    args = parse_args(sys.argv[1:] if argv is None else list(argv))
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    group, rank, world = None, 0, 1
    if args.distributed:
        multihost.initialize(device=args.device)
        dev, group = multihost.local_device(), multihost.global_group()
        rank, world = multihost.process_index(), multihost.process_count()
    rows = multihost.rank_rows(args.batch, world, rank)
    on_card = dev.type == "cuda"
    configure_numerics()
    cam = PinholeCamera.create(fx=FOCAL, fy=FOCAL, u0=W / 2, v0=H / 2,
                               width=W, height=H)
    cfg = NetworkConfig(code_size=CS, pyramid_levels=LEVELS, input_width=W,
                        input_height=H, avg_dpt=AVG_DPT, fx=FOCAL, fy=FOCAL,
                        u0=W / 2, v0=H / 2, base_ch=args.base_ch,
                        pred_head=args.pred_head)

    log("rendering training set...")
    t0 = time.time()
    sr = (args.scale_lo, args.scale_hi)
    imgs, dpts = build_dataset(args.rooms, args.poses_per_room, H, W, cam,
                               seed=0, randomize=args.randomize,
                               scale_range=sr, device=dev)
    val_imgs, val_dpts = build_dataset(args.val_rooms, 16, H, W, cam,
                                       seed=99991, randomize=args.randomize,
                                       scale_range=sr, device=dev)
    gts = wp.depth_to_prox(dpts, AVG_DPT)
    del dpts
    n = imgs.shape[0]
    if on_card:
        torch.cuda.synchronize()
    dataset_s = time.time() - t0
    log(f"dataset: {n} train / {val_imgs.shape[0]} val frames "
        f"({dataset_s:.1f}s)")

    model = VAEModel(CS, LEVELS, args.base_ch, args.pred_head, (H, W))
    init_flax_defaults(model, torch.Generator().manual_seed(0))
    model.to(dev).train()
    opt = OptaxAdam(model.parameters(),
                    cosine_decay_schedule(args.lr, args.steps, alpha=0.1),
                    weight_decay=1e-4, clip_norm=1.0)
    step_fn = make_train_step(model, opt, args.beta, args.distill_w, group)
    aug_fn = make_augment(args.aug_strength) if args.randomize else None
    gen = torch.Generator(device=dev).manual_seed(0)

    nll = torch.empty(args.steps, device=dev)
    logged = []
    if on_card:
        torch.cuda.reset_peak_memory_stats()
        marks = [torch.cuda.Event(enable_timing=True)
                 for _ in range(args.steps + 1)]
        marks[0].record()
    else:
        host = [time.perf_counter()]
    t0 = time.time()
    for i in range(args.steps):
        idx = torch.randint(0, n, (args.batch,), generator=gen,
                            device=dev)[rows]
        bi, bg = imgs[idx], gts[idx]
        if aug_fn is not None:
            bi = aug_fn(bi, gen, args.batch, rows)
        loss, aux = step_fn(bi, bg, generator=gen)
        nll[i] = aux["nll"]
        if on_card:
            marks[i + 1].record()
        else:
            host.append(time.perf_counter())
        if i % args.log_every == 0 or i == args.steps - 1:
            lf = float(loss)
            logged.append((i, lf))
            log(f"step {i}: loss={lf:.4f} nll={float(aux['nll']):.4f} "
                f"kl={float(aux['kl']):.2f} "
                f"distill={float(aux['distill']):.3f} "
                f"({(time.time() - t0):.0f}s)")
        if i > 0 and i % CKPT_EVERY == 0 and rank == 0:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            save_params(args.out + ".ckpt.pkl", extract_decoder_params(model))
    if on_card:
        torch.cuda.synchronize()
        step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        peak = torch.cuda.max_memory_allocated()
    else:
        step_ms = list(1e3 * np.diff(host))
        peak = None
    train_s = time.time() - t0
    warm = step_ms[min(10, len(step_ms) - 1):]
    log(f"trained {args.steps} steps in {train_s:.1f} s on {dev}: ms per "
        f"step median {np.median(warm):.3f} (after 10)"
        + (f", peak device memory {peak / 2**20:.1f} MiB" if on_card else "")
        + (f"; rank {rank} of {world}" if group is not None else ""))
    summary = {"nll": nll.cpu().numpy(), "logged": logged,
               "step_ms": step_ms, "peak_bytes": peak, "val": None,
               "dataset_s": dataset_s, "train_s": train_s, "frames": n,
               "out": args.out, "rank": rank, "world": world}
    if group is not None:
        flat = torch.cat([p.detach().reshape(-1)
                          for p in model.parameters()])
        ref = flat.clone()
        torch.distributed.broadcast(ref, 0, group=group)
        if not torch.equal(ref, flat):
            raise RuntimeError(f"rank {rank}'s parameters differ from rank "
                               f"0's after {args.steps} steps")
        log(f"parameters bit-identical over {world} ranks")
        if rank != 0:
            return summary

    dec_params = extract_decoder_params(model)
    decoder = Decoder(cfg, params=dec_params, device=dev)
    mean = evaluate(decoder, val_imgs, val_dpts)
    log(f"val depth RMSE: zero-code={mean[0]:.4f}m "
        f"pred-code={mean[1]:.4f}m opt-code={mean[5]:.4f}m | "
        f"prox RMSE: zero={mean[2]:.4f} pred={mean[3]:.4f} | "
        f"code rms pred={mean[4]:.3f} opt={mean[6]:.3f}")

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    save_params(args.out + ".pkl", dec_params)
    with open(args.out + ".json", "w") as f:
        json.dump({
            "code_size": CS, "pyramid_levels": LEVELS, "input_width": W,
            "input_height": H, "avg_dpt": AVG_DPT, "grayscale": True,
            "fx": FOCAL, "fy": FOCAL, "u0": W / 2, "v0": H / 2,
            "base_ch": args.base_ch, "pred_head": args.pred_head,
            "trained_on": (f"io.synth room_dataset ({args.rooms} rooms x "
                           f"{args.poses_per_room} views), {args.steps} "
                           f"steps adamw {args.lr}, beta {args.beta}"),
            "val_depth_rmse_zero_code": round(float(mean[0]), 4),
            "val_depth_rmse_pred_code": round(float(mean[1]), 4),
            "val_depth_rmse_opt_code": round(float(mean[5]), 4),
            "val_prox_rmse_zero_code": round(float(mean[2]), 4),
            "val_prox_rmse_pred_code": round(float(mean[3]), 4),
        }, f, indent=1)
    log(f"saved {args.out}.pkl")
    summary["val"] = mean
    return summary


if __name__ == "__main__":
    main()
    from .parallel import multihost
    multihost.shutdown()
