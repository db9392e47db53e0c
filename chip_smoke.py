"""Smoke run of the PyTorch/CUDA port (deepfactors_tpu_torch) on one GPU.

Phases, in order (any failure exits non-zero before the final line):
  1. card name + power limit (nvidia-smi); build the CUDA kernels from
     deepfactors_tpu_torch/csrc (one nvcc per source, in parallel).
  2. each kernel against its plain PyTorch twin on the card, at the main
     path's shapes (192x256, 96x128, 48x64 levels, K = 32 keyframe pools):
     sfm_gram_batch at P = 128 with half the slots inactive, CS 32 and 8,
     Huber/Tukey, from-prox on/off, interp/sampled; se3_gram_batch at
     P = 1 and 8. Times kernel and twin at each level with CUDA events.
  3. the room256_32v4 decoder forward at 192x256 on the card, held against
     the same module on the CPU.
  4. end to end: the sequential DeepFactors facade on 60 frames of the
     synthetic room orbit (tools/bench_e2e.py's configuration without loop
     closure and reprojection factors), bootstrap on frames 0 and 2.
Then a ``kernels`` JSON line, the nvidia-smi line, and as the last line
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Run from the repository root:  python3 chip_smoke.py
Option: --ptxas (print nvcc's register/shared-memory report).
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

# Tolerance of kernel vs plain twin, per factor and per block of G, each on
# its own scale: JtJ (G[:DB,:DB]) over max|JtJ|, Jtr (G[:DB,DB]) over
# max|Jtr|, the residual G[DB,DB] relative to itself; the inlier count
# G[DB+1,DB+1] exactly. Both sides are fp32 and compute every pixel's row
# with the same op-by-op rounding (the kernels build with --fmad=false, so
# validity is bit-identical); they differ in the order of the Gram
# summation (strip partials + fixed-order tree in the kernel, cuBLAS in the
# twin). Over 12k-49k pixels that order costs ~sqrt(N)·2^-24 ≈ 1e-5 of a
# block's largest entry; 1e-4 leaves a factor ten. The poses are perturbed
# off the true relative poses (POSE_NOISE) so that residuals and Jtr are
# far from zero and a wrong sign or a missing weight shows.
KERNEL_TOL = 1e-4
POSE_NOISE = (0.02, 0.005)   # translation (m), rotation (rad) per axis
# Rigid ATE bound for the 60-frame run, just above both readings it was set
# from (PERF.md section 2): the JAX facade's own CPU run of the same
# configuration, 0.0684 m (port_tools/jax_smoke_reference.py), and the
# port's card runs of this script, 0.0662-0.0673 m.
ATE_BOUND_M = 0.085
# decoder card vs CPU: bf16 activations round differently in cuDNN and in
# the CPU convolution; 2e-2 of the largest |value| per output.
DECODER_TOL = 2e-2
H, W = 192, 256
N_FRAMES = 60
SEQ_LEN = 300


def log(*a):
    print(*a, flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3):
    """Device milliseconds per call of ``fn``: CUDA events around ``iters``
    back-to-back calls. A ~50 ms spin kernel is queued first, so the host
    has enqueued every call before the first one starts and the events
    time the device's work, not the Python wrapper's launch rate."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


PEAK_FP32_FLOPS = 67e12     # H100 SXM, fp32 outside the tensor cores
PEAK_BYTES = 3.35e12        # H100 SXM HBM3


def bound(nbytes, flops):
    tb, to = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FP32_FLOPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# ----------------------------------------------------------------------------
# phase 2: kernels vs plain twins
# ----------------------------------------------------------------------------

def make_pools(dev, K=32, CS=32, seed=0):
    """Keyframe pools of a real scene: rendered room views (images, Sobel
    planes, depth), a random small code Jacobian and codes, the true
    camera-to-world poses."""
    import torch
    from deepfactors_tpu_torch.geometry.camera import PinholeCamera
    from deepfactors_tpu_torch.io import synth
    from deepfactors_tpu_torch.ops import image as ip

    cam = PinholeCamera.create(fx=220.0, fy=220.0, u0=W / 2, v0=H / 2,
                               width=W, height=H)
    scene = synth.random_room(3, n_boxes=3)
    poses = synth.orbit_trajectory(SEQ_LEN, sweep=3.2 * np.pi)[:K]
    g = torch.Generator(device="cpu").manual_seed(seed)
    imgs, dpts = [], []
    for p in poses:
        im, dp = synth.render_aa(scene, cam, p, H, W, device=dev)
        imgs.append(im)
        dpts.append(dp)
    img = torch.stack(imgs)
    dpt = torch.stack(dpts)
    levels = []
    for l in range(3):
        if l:
            img = ip.gaussian_blur_down(img)
            dpt = ip.gaussian_blur_down(dpt)
        grad = ip.sobel_gradients(img)
        jac = (0.01 * torch.randn((K, CS) + img.shape[1:], generator=g)).to(dev)
        levels.append(dict(img=img.contiguous(), dpt=dpt.contiguous(),
                           gx=grad[..., 0].contiguous(),
                           gy=grad[..., 1].contiguous(), jac=jac))
    q = torch.tensor(np.stack([p.q for p in poses]), device=dev)
    t = torch.tensor(np.stack([p.t for p in poses]), device=dev)
    codes = (0.1 * torch.randn((K, CS), generator=g)).to(dev)
    return cam, levels, q, t, codes


def factor_set(K, P, dev, seed=1):
    import torch
    rng = np.random.RandomState(seed)
    src = rng.randint(0, K, P)
    dst = np.clip(src + rng.choice([-2, -1, 1, 2], P), 0, K - 1)
    dst = np.where(dst == src, (src + 1) % K, dst)
    active = np.zeros(P, np.int32)
    active[rng.permutation(P)[:P // 2]] = 1
    t = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)
    return t(src), t(dst), t(active)


def perturb(pose, seed):
    """pose (batched [P]) moved off by POSE_NOISE, seeded."""
    import torch
    from deepfactors_tpu_torch.geometry import se3 as se3m
    rng = np.random.RandomState(seed)
    P = pose.t.shape[0]
    d = np.concatenate([POSE_NOISE[0] * rng.standard_normal((P, 3)),
                        POSE_NOISE[1] * rng.standard_normal((P, 3))], axis=1)
    return se3m.retract(pose, torch.tensor(d, dtype=torch.float32,
                                           device=pose.t.device))


def block_errs(Gk, Gp, DB):
    """Kernel vs twin by block of G, each on its own per-factor scale:
    {jtj, jtr, res (relative errors), inl (max abs diff of the inlier
    count), g (relative to max|G|, all of G), abs (max abs diff over G)}."""
    def rel(a, b):
        d = (a - b).abs().flatten(1).max(dim=1).values
        s = b.abs().flatten(1).max(dim=1).values.clamp(min=1e-12)
        return float((d / s).max())
    return dict(jtj=rel(Gk[:, :DB, :DB], Gp[:, :DB, :DB]),
                jtr=rel(Gk[:, :DB, DB], Gp[:, :DB, DB]),
                res=rel(Gk[:, DB, DB, None], Gp[:, DB, DB, None]),
                inl=float((Gk[:, DB + 1, DB + 1] - Gp[:, DB + 1, DB + 1])
                          .abs().max()),
                g=rel(Gk, Gp), abs=float((Gk - Gp).abs().max()))


def phase_kernels(dev):
    import torch
    from deepfactors_tpu_torch.geometry import se3 as se3m
    from deepfactors_tpu_torch.geometry.camera import camera_pyramid
    from deepfactors_tpu_torch.geometry.se3 import SE3
    from deepfactors_tpu_torch.geometry.warping import depth_to_prox
    from deepfactors_tpu_torch.ops.kernels import sfm_gram as sg

    K = 32
    cam, levels, q, t, codes_k = make_pools(dev, K=K, CS=32)
    cams = camera_pyramid(cam, 3)
    results = {}
    worst = {n: dict.fromkeys(("jtj", "jtr", "res", "inl", "g", "abs"), 0.0)
             for n in ("se3_gram_batch", "sfm_gram_batch")}

    def record(name, errs, Gp, DB):
        w = worst[name]
        for k, v in errs.items():
            w[k] = max(w[k], v)
        on = Gp[:, DB + 1, DB + 1] > 0
        assert bool((Gp[on, :DB, DB].abs().amax(dim=1) > 0).all()), \
            f"{name}: an active factor has Jtr = 0"
        assert errs["inl"] == 0, f"{name}: inlier counts differ: {errs}"
        for k in ("jtj", "jtr", "res"):
            assert errs[k] < KERNEL_TOL, f"{name}: {k} rel err {errs} >= {KERNEL_TOL}"

    def summary(name, n):
        w = worst[name]
        log(f"{name}: {n} checks, max rel err JtJ {w['jtj']:.3e}, Jtr "
            f"{w['jtr']:.3e}, residual {w['res']:.3e} (tol {KERNEL_TOL}); "
            f"inlier counts equal; of max|G| {w['g']:.3e}, max abs err "
            f"{w['abs']:.3e}")

    # --- sfm_gram_batch --------------------------------------------------
    P = 128
    src, dst, active = factor_set(K, P, dev)
    sl, dl = src.long(), dst.long()
    pose_10, _, _ = se3m.relative_pose_jacobians(SE3(q[dl], t[dl]),
                                                 SE3(q[sl], t[sl]))
    pose_10 = perturb(pose_10, seed=3)
    n_checks = 0
    for l, lv in enumerate(levels):
        for CS in (32, 8):
            jac = lv["jac"][:, :CS].contiguous()
            codes = codes_k[:, :CS][sl].contiguous()
            # prx0 such that prx0 + jac·code reproduces the rendered depth
            prx = depth_to_prox(lv["dpt"], 2.0)
            prx0 = (prx - torch.einsum("kchw,kc->khw", jac, codes_k[:, :CS])).contiguous()
            for loss in ("huber", "tukey"):
                kp = sg.make_sfm_params(pose_10, cams[l], 2, 0.0,
                                        0.1 if loss == "tukey" else 0.3, 2.0)
                for from_prox in (False, True):
                    for gm in ("interp", "sampled"):
                        args = (kp, src, dst, lv["img"],
                                prx0 if from_prox else lv["dpt"], jac,
                                lv["img"], lv["gx"], lv["gy"])
                        kw = dict(active=active,
                                  codes=codes if from_prox else None,
                                  grad_mode=gm, loss=loss)
                        Gk = sg.sfm_gram_batch(*args, **kw)
                        Gp = sg.sfm_gram_batch_plain(*args, **kw)
                        torch.cuda.synchronize()
                        assert torch.isfinite(Gk).all()
                        assert (Gk[active == 0] == 0).all()
                        record("sfm_gram_batch",
                               block_errs(Gk, Gp, 6 + CS), Gp, 6 + CS)
                        n_checks += 1
                        # the main path: CS 32, depth from the codes,
                        # interp gradients, Tukey at level 0, Huber above
                        main = (CS == 32 and from_prox and gm == "interp"
                                and loss == ("tukey" if l == 0 else "huber"))
                        if main:
                            ms_k = cuda_ms(lambda: sg.sfm_gram_batch(*args, **kw))
                            ms_p = cuda_ms(lambda: sg.sfm_gram_batch_plain(*args, **kw),
                                           iters=5)
                            R = CS + 8
                            N = lv["img"].shape[1] * lv["img"].shape[2]
                            on = active.bool()
                            n_src = len(set(src[on].tolist()))
                            n_dst = len(set(dst[on].tolist()))
                            inl = float(Gp[on, R - 1, R - 1].sum())
                            nbytes = (n_src * (2 + CS) * N * 4 + n_dst * N * 4
                                      + P * (sg.PARAM_DIM + CS + 3) * 4
                                      + P * R * R * 4)
                            flops = inl * (R * (R + 1) + 2 * CS + 160)
                            bms, by = bound(nbytes, flops)
                            hw = "x".join(map(str, lv["img"].shape[1:]))
                            results.setdefault("sfm_gram_batch", []).append(dict(
                                ms=ms_k, plain_ms=ms_p, bound_ms=bms,
                                bound_by=by, shape=f"P={P} ({int(on.sum())} active) "
                                f"CS={CS} {hw} {loss} from-prox interp"))
    summary("sfm_gram_batch", n_checks)

    # --- se3_gram_batch --------------------------------------------------
    n_checks = 0
    for P in (1, 8):
        src, dst, _ = factor_set(K, P, dev, seed=2)
        active = torch.ones(P, dtype=torch.int32, device=dev)
        sl, dl = src.long(), dst.long()
        pose_10 = perturb(se3m.relative_pose(SE3(q[dl], t[dl]),
                                             SE3(q[sl], t[sl])), seed=4 + P)
        for l, lv in enumerate(levels):
            kp = sg.make_sfm_params(pose_10, cams[l], 1, 0.0, 0.3, 2.0)
            for gm in ("interp", "sampled"):
                args = (kp, src, dst, lv["img"], lv["dpt"], lv["img"],
                        lv["gx"], lv["gy"])
                kw = dict(active=active, grad_mode=gm)
                Gk = sg.se3_gram_batch(*args, **kw)
                Gp = sg.se3_gram_batch_plain(*args, **kw)
                torch.cuda.synchronize()
                assert torch.isfinite(Gk).all()
                record("se3_gram_batch", block_errs(Gk, Gp, 6), Gp, 6)
                n_checks += 1
                if P == 1 and gm == "interp":
                    ms_k = cuda_ms(lambda: sg.se3_gram_batch(*args, **kw), iters=100)
                    ms_p = cuda_ms(lambda: sg.se3_gram_batch_plain(*args, **kw))
                    N = lv["img"].shape[1] * lv["img"].shape[2]
                    inl = float(Gp[0, 7, 7])
                    nbytes = 3 * N * 4 + (sg.PARAM_DIM + 3) * 4 + 64 * 4
                    flops = inl * (72 + 90)
                    bms, by = bound(nbytes, flops)
                    hw = "x".join(map(str, lv["img"].shape[1:]))
                    results.setdefault("se3_gram_batch", []).append(dict(
                        ms=ms_k, plain_ms=ms_p, bound_ms=bms, bound_by=by,
                        shape=f"P=1 {hw} interp"))
    summary("se3_gram_batch", n_checks)
    for name, per_level in results.items():
        for r in per_level:
            log(f"{name} at {r['shape']}: kernel {r['ms']:.4f} ms, plain "
                f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']})")
    # the kernels line reports the finest level, where the main path spends
    # most of each kernel's time
    out = {name: dict(per_level[0]) for name, per_level in results.items()}
    for name, r in out.items():
        w = worst[name]
        r["max_abs_err"] = w["abs"]
        r["max_rel_err"] = {k: w[k] for k in ("jtj", "jtr", "res", "g")}
    return out


# ----------------------------------------------------------------------------
# phase 3: decoder
# ----------------------------------------------------------------------------

def phase_decoder(dev):
    import torch
    from deepfactors_tpu_torch.models.decoder import load_decoder

    dec = load_decoder(os.path.join("data", "nets", "room256_32v4"), device=dev)
    rng = np.random.RandomState(0)
    img = torch.tensor(rng.rand(H, W).astype(np.float32), device=dev)
    ms = cuda_ms(lambda: dec.raw_outputs_T(img), iters=10)
    out = dec.raw_outputs_T(img)
    dec_cpu = load_decoder(os.path.join("data", "nets", "room256_32v4"),
                           device="cpu")
    ref = dec_cpu.raw_outputs_T(img.cpu())
    for key in ("prx0", "jac", "stdev"):
        for a, b in zip(out[key], ref[key]):
            assert torch.isfinite(a).all()
            err = float((a.cpu() - b).abs().max() / b.abs().max())
            assert err < DECODER_TOL, f"decoder {key}: {err}"
    err = float((out["code_pred"].cpu() - ref["code_pred"]).abs().max()
                / ref["code_pred"].abs().max())
    assert err < DECODER_TOL, f"decoder code_pred: {err}"
    log("decoder room256_32v4: prx0 "
        + str([tuple(p.shape) for p in out["prx0"]]) + ", jac "
        + str([tuple(j.shape) for j in out["jac"]]) + ", code "
        + str(tuple(out["code_pred"].shape)) + f"; forward {ms:.3f} ms; "
        f"card vs CPU within {DECODER_TOL}")
    return dec


# ----------------------------------------------------------------------------
# phase 4: end to end
# ----------------------------------------------------------------------------

def phase_e2e(dev, decoder):
    import torch
    from deepfactors_tpu_torch.geometry.camera import PinholeCamera
    from deepfactors_tpu_torch.io import synth
    from deepfactors_tpu_torch.mapping.mapper import MapperConfig
    from deepfactors_tpu_torch.ops.kernels import sfm_gram as sg
    from deepfactors_tpu_torch.system import DeepFactors, SystemConfig
    from deepfactors_tpu_torch.utils import tum_io

    cam = PinholeCamera.create(fx=220.0, fy=220.0, u0=W / 2, v0=H / 2,
                               width=W, height=H)
    scene = synth.random_room(7, n_boxes=3)
    poses = synth.orbit_trajectory(SEQ_LEN, sweep=3.2 * np.pi)[:N_FRAMES]
    frames = synth.render_sequence(scene, cam, poses, H, W, device=dev)
    cfg = SystemConfig(
        mapper=MapperConfig(
            max_keyframes=32, max_frames=2, max_factors=128, code_size=32,
            height=H, width=W, pyramid_levels=3, pho_iters=(4, 8, 15),
            connection_mode="LASTN", max_back_connections=2,
            use_reprojection=False),
        dist_threshold=2.0, tracking_dist_threshold=5.0,
        frame_dist_threshold=0.12, loop_closure=False)
    df = DeepFactors(cfg, cam, decoder=decoder, device=dev)

    sg.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    df.bootstrap_two_frames(frames[0], frames[2], frame_gap=2)
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    df.trajectory = [(0.0, df.pose_wc)]
    # per event kind: host milliseconds of each frame, and the kernel
    # launches the kind made in all
    ms_by = {"tracking-only frames": [], "one-way-frame events": [],
             "keyframe events": []}
    launches_by = {k: dict.fromkeys(sg.LAUNCHES, 0) for k in ms_by}
    launches_by["bootstrap"] = dict(sg.LAUNCHES)
    n_frames_enq = int(df.mapper.frames.next_id)
    for i in range(3, N_FRAMES):
        n_kf = len(df.mapper.kf_slots)
        before = dict(sg.LAUNCHES)
        t1 = time.perf_counter()
        df.process_frame(float(i), frames[i])
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t1) * 1e3
        n_fr = int(df.mapper.frames.next_id)
        kind = ("keyframe events" if len(df.mapper.kf_slots) > n_kf else
                "one-way-frame events" if n_fr > n_frames_enq else
                "tracking-only frames")
        n_frames_enq = n_fr
        ms_by[kind].append(dt)
        for k, v in sg.LAUNCHES.items():
            launches_by[kind][k] += v - before[k]
    total_s = time.perf_counter() - t0
    launches = dict(sg.LAUNCHES)

    est = df.trajectory
    for _, p in est:
        assert np.isfinite(p.q).all() and np.isfinite(p.t).all(), "non-finite pose"
    gt = [(ts, poses[int(ts)]) for ts, _ in est]
    ate = tum_io.ate_rmse(est, gt)
    tracked = 1.0 - df.n_lost_frames / max(df.n_frames, 1)
    stat = lambda v: (f"n={len(v)} mean {np.mean(v):.1f} median "
                      f"{np.median(v):.1f} max {np.max(v):.1f} ms"
                      if v else "n=0")
    log(f"e2e: {df.n_frames} frames after bootstrap ({boot_s:.2f} s), total "
        f"{total_s:.2f} s, {1e3 * total_s / N_FRAMES:.1f} ms/frame overall")
    for kind, v in ms_by.items():
        log(f"e2e {kind}: {stat(v)}")
    log(f"e2e keyframes {len(df.mapper.kf_slots)}, one-way frames "
        f"{len(ms_by['one-way-frame events'])}, tracked fraction "
        f"{tracked:.4f}, lost {df.n_lost_frames}, rigid ATE {ate:.4f} m "
        f"(bound {ATE_BOUND_M})")
    log(f"e2e kernel launches: {launches}; by event kind: {launches_by}")
    assert df.n_lost_frames == 0, "frames lost"
    assert all(v > 0 for v in launches.values()), f"kernel not launched: {launches}"
    assert ate < ATE_BOUND_M, f"ATE {ate} >= {ATE_BOUND_M}"
    return launches


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ptxas", action="store_true")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import deepfactors_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable: {e}", file=sys.stderr)
        return 3
    from deepfactors_tpu_torch.ops.kernels import build

    dev = "cuda"
    smi = smi_line()
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    build_s = build.build_all(ptxas_verbose=args.ptxas)
    log(f"kernel build: {build_s:.2f} s "
        + str({k: round(v['seconds'], 2) for k, v in build.build_log.items()}))
    if args.ptxas:
        for src, v in build.build_log.items():
            log(f"--- {src}\n{v['ptxas']}")

    kern = phase_kernels(dev)
    decoder = phase_decoder(dev)
    launches = phase_e2e(dev, decoder)

    meta = {
        "se3_gram_batch": ("deepfactors_tpu_torch/csrc/se3_gram.cu",
                           "deepfactors_tpu/ops/pallas/sfm_kernel.py:680"),
        "sfm_gram_batch": ("deepfactors_tpu_torch/csrc/sfm_gram.cu",
                           "deepfactors_tpu/ops/pallas/sfm_kernel.py:545"),
    }
    rows = []
    for name, (src, rep) in meta.items():
        r = kern[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "launches": launches[name],
                     "max_abs_err": r["max_abs_err"],
                     "max_rel_err": r["max_rel_err"],
                     "ms": r["ms"], "plain_ms": r["plain_ms"],
                     "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                     "library_ms": None, "shape": r["shape"]})
    log(json.dumps({"kernels": rows}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
