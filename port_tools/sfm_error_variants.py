"""Time design variants of the error kernel (csrc/sfm_error.cu) in turns,
inside one process on one card: what its design was chosen against.

Each variant is csrc/sfm_error.cu with one change made by text
substitution, built by nvcc with the port's flags into ``--out``:
  - final: the source as it is;
  - strip_order: the last block sums the strips' partials one after
    another in strip order (one thread a sum), not by the shuffle tree;
  - regs40 / regs32: 2 / 1 pixels loaded at a time under
    __launch_bounds__(256, 6 / 8), i.e. 40 / 32 registers;
  - fast_div, no_gather: ablations that change the results and are timed
    only: the correspondence's and the Huber weight's divisions as
    __fdividef, or no gather of the target image (a stand-in from the
    warped coordinates).
Each is launched through its C interface with the strip plan of
``sfm_gram.launch_plan`` under a given residency (blocks an SM) and pixel
cap, at chip_smoke.py's timed shapes (the keyframe gate, the map dump, one
render) plus the dump with every factor active. The exact variants are held
against the plain twin (inliers equal, residual within 1e-4). Then
variants/sfm_error_cluster.cu (one cluster of 1024-thread blocks per factor
reduced through distributed shared memory) at the gate, beside the port's
kernel. Times come from chip_smoke.cuda_ms, in the order final ... cluster,
then back, both printed with the card's name and power limit.

Run from the repository root on a machine with a GPU:
    python3 port_tools/sfm_error_variants.py [--out build/variants] [--json PATH]
"""
import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

FINAL_SUM = '''  float2 sv = make_float2(0.0f, 0.0f);
  if (tid < nblk)
    sv = __ldcg(reinterpret_cast<const float2*>(part) + (size_t)p * nblk + tid);
  const float total = block_sum2(sv.x, sv.y, warp_sums);
  if (tid < 2) out[p * 2 + tid] = total;'''
STRIP_ORDER_SUM = '''  __shared__ float2 strips[kThreads];
  if (tid < nblk)
    strips[tid] = __ldcg(reinterpret_cast<const float2*>(part) +
                         (size_t)p * nblk + tid);
  __syncthreads();
  if (tid < 2) {
    float v = 0.0f;
    for (int k = 0; k < nblk; ++k) v += tid ? strips[k].y : strips[k].x;
    out[p * 2 + tid] = v;
  }'''
GATHER = "dfk::interp_value(im1, dfk::corners(w.x1, w.y1, H, W))"
FAST_DIV = (("w.u = (xs - f.u0) / f.fx;", "w.u = __fdividef(xs - f.u0, f.fx);"),
            ("w.v = (ys - f.v0) / f.fy;", "w.v = __fdividef(ys - f.v0, f.fy);"),
            ("f.fx * w.tx / zsafe", "__fdividef(f.fx * w.tx, zsafe)"),
            ("f.fy * w.ty / zsafe", "__fdividef(f.fy * w.ty, zsafe)"),
            ("sqrtf(delta * (2.0f * aa - delta)) / fmaxf(aa, 1e-12f)",
             "__fdividef(sqrtf(delta * (2.0f * aa - delta)), fmaxf(aa, 1e-12f))"))
# (variant, resident blocks an SM the plan assumes, pixels a thread at most)
CONFIGS = ([("final", 4, cap) for cap in (1, 2, 3, 4, 8, 16)]
           + [("strip_order", 4, 4), ("regs40", 6, 4), ("regs32", 8, 4),
              ("fast_div", 4, 4), ("no_gather", 4, 4)])
EXACT = ("final", "strip_order", "regs40", "regs32")


def sources(csrc):
    """{variant: (source text, header text)} from csrc's two files."""
    src = open(os.path.join(csrc, "sfm_error.cu")).read()
    hdr = open(os.path.join(csrc, "sfm_common.cuh")).read()
    for old in (FINAL_SUM, GATHER, "constexpr int kBatch = 4;",
                "__launch_bounds__(kThreads, 4)"):
        assert old in src, f"sfm_error.cu no longer holds {old!r}"
    fast = hdr
    for old, new in FAST_DIV:
        assert old in fast, f"sfm_common.cuh no longer holds {old!r}"
        fast = fast.replace(old, new)

    def regs(batch, blocks):
        return (src.replace("constexpr int kBatch = 4;",
                            f"constexpr int kBatch = {batch};")
                .replace("__launch_bounds__(kThreads, 4)",
                         f"__launch_bounds__(kThreads, {blocks})"))
    return {"final": (src, hdr),
            "strip_order": (src.replace(FINAL_SUM, STRIP_ORDER_SUM), hdr),
            "regs40": (regs(2, 6), hdr), "regs32": (regs(1, 8), hdr),
            "fast_div": (src, fast),
            "no_gather": (src.replace(GATHER, "(w.x1 * 0.001f + w.y1 * 0.002f)"),
                          hdr)}


def build_all(out, build, csrc):
    """Build every variant (and the cluster kernel), one nvcc each, all
    started together; returns ({name: CDLL}, {name: ptxas lines})."""
    procs = []
    for name, (src, hdr) in sources(csrc).items():
        d = os.path.join(out, name)
        os.makedirs(d, exist_ok=True)
        open(os.path.join(d, "sfm_error.cu"), "w").write(src)
        open(os.path.join(d, "sfm_common.cuh"), "w").write(hdr)
        procs.append((name, os.path.join(d, "lib.so"), os.path.join(d, "sfm_error.cu")))
    d = os.path.join(out, "cluster")
    os.makedirs(d, exist_ok=True)
    shutil.copy(os.path.join(csrc, "sfm_common.cuh"), d)
    shutil.copy(os.path.join(ROOT, "port_tools", "variants", "sfm_error_cluster.cu"), d)
    procs.append(("cluster", os.path.join(d, "lib.so"),
                  os.path.join(d, "sfm_error_cluster.cu")))
    running = [(name, lib, subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas=-v", "-o", lib, src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for name, lib, src in procs]
    libs, report = {}, {}
    for name, lib, proc in running:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{text}")
        report[name] = sorted({ln.strip() for ln in text.splitlines()
                               if "registers" in ln or "spill" in ln})
        libs[name] = ctypes.CDLL(lib)
        fn = libs[name].err_cluster_launch if name == "cluster" else \
            libs[name].sfm_error_launch
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                       if name == "cluster" else
                       [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8) + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return libs, report


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "variants"))
    ap.add_argument("--json", default=None)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("sfm_error_variants: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from deepfactors_tpu_torch.geometry.camera import camera_pyramid
    from deepfactors_tpu_torch.ops.kernels import build
    from deepfactors_tpu_torch.ops.kernels import sfm_error as se
    from deepfactors_tpu_torch.ops.kernels import sfm_gram as sg

    dev = "cuda"
    smi = cs.smi_line()
    cs.log(smi)
    build.build_all()
    libs, report = build_all(args.out, build, str(build.CSRC))
    for name, lines in report.items():
        cs.log(f"{name}: " + "; ".join(lines))
    p = sg._ptr
    stream = lambda: torch.cuda.current_stream().cuda_stream

    def plan(P, H, W, blocks, cap):
        keep = sg._ERR_BLOCKS_PER_SM, sg._ERR_MAX_PX
        sg._ERR_BLOCKS_PER_SM, sg._ERR_MAX_PX = blocks, cap
        sg.launch_plan.cache_clear()
        try:
            pl = sg.launch_plan("sfm_error_batch", P, H, W)
        finally:
            sg._ERR_BLOCKS_PER_SM, sg._ERR_MAX_PX = keep
            sg.launch_plan.cache_clear()
        return pl.px_per_blk, pl.nblk

    def run(lib, a, active, mode, per, nblk):
        kp, src, dst, img0, dpt, img1 = a
        P, (K, H, W) = src.shape[0], img0.shape
        part = torch.empty((P, nblk, 2), device=dev)
        out = torch.empty((P, 2), device=dev)
        warped = torch.empty((P, H, W), device=dev) if mode else None
        st = stream()
        code = lib.sfm_error_launch(
            p(kp), p(src), p(dst), p(active), p(img0), p(dpt), p(img1),
            p(warped), p(part), p(out), p(sg._tickets(img0.device, st, P)), P,
            K, img1.shape[0], H, W, per, nblk, mode, ctypes.c_void_p(st))
        assert code == 0, code
        return out[:, 0], out[:, 1]

    K = 32
    cam, levels, q, t, _ = cs.make_pools(dev, K=K, CS=32)
    cams = camera_pyramid(cam, 3)
    size = lambda lv: "x".join(map(str, lv["img"].shape[1:]))
    ones = lambda n: torch.ones(n, dtype=torch.int32, device=dev)
    gate = cs.gate_case(dev, levels[0], cams[0], q, t)
    shapes = [(f"gate P=2 {size(levels[0])}", gate, ones(2), 0)]
    for l, lv in enumerate(levels):
        a, act = cs.error_case(dev, K, 64, lv, cams[l], q, t)
        shapes.append((f"dump P=64 (32 active) {size(lv)}", a, act, 0))
    for l in (0, 2):
        a, act = cs.error_case(dev, K, 1, levels[l], cams[l], q, t)
        shapes.append((f"render P=1 {size(levels[l])}", a, act, 1))
    a, _ = cs.error_case(dev, K, 64, levels[0], cams[0], q, t)
    shapes.append((f"dump P=64 (all active) {size(levels[0])}", a, ones(64), 0))

    rows = []
    for shape, a, act, mode in shapes:
        H, W = a[3].shape[1:]
        P = a[1].shape[0]
        twin = (se.se3_warp_batch_plain if mode else se.sfm_error_batch_plain)(
            *a, active=act)
        times = {}
        for order in (CONFIGS, CONFIGS[::-1]):
            for name, blocks, cap in order:
                per, nblk = plan(P, H, W, blocks, cap)
                f = lambda: run(libs[name], a, act, mode, per, nblk)
                res, inl = f()
                torch.cuda.synchronize()
                if name in EXACT:
                    assert torch.equal(inl, twin[-1]), (shape, name)
                    rel = ((res - twin[-2]).abs()
                           / twin[-2].abs().clamp(min=1e-12)).max()
                    assert float(rel) < 1e-4, (shape, name, float(rel))
                times.setdefault((name, blocks, cap, per // 256, nblk), []).append(
                    1e3 * cs.cuda_ms(f, iters=100))
        for (name, blocks, cap, ppt, nblk), us in times.items():
            rows.append(dict(shape=shape, variant=name, blocks_per_sm=blocks,
                             max_px=cap, px_per_thread=ppt, strips=nblk, us=us))

    # the cluster variant at the gate, in turns with the port's kernel
    N = gate[3].shape[1] * gate[3].shape[2]

    def cluster(ppt):
        kp, src, dst, img0, dpt, img1 = gate
        out = torch.empty((2, 2), device=dev)
        per = 1024 * ppt
        code = libs["cluster"].err_cluster_launch(
            p(kp), p(src), p(dst), p(img0), p(dpt), p(img1), p(out), 2,
            img0.shape[0], img1.shape[0], img0.shape[1], img0.shape[2], per,
            -(-N // per), ctypes.c_void_p(stream()))
        assert code == 0, code
        return out[:, 0], out[:, 1]

    twin = se.sfm_error_batch_plain(*gate)
    on2 = ones(2)
    turns = [("port", lambda: se.sfm_error_batch(*gate, active=on2))]
    for ppt in (3, 4, 6):
        res, inl = cluster(ppt)
        torch.cuda.synchronize()
        assert torch.equal(inl, twin[1]), ppt
        turns.append((f"cluster of {-(-N // (1024 * ppt))} blocks, {ppt} px a thread",
                      lambda ppt=ppt: cluster(ppt)))
    ctimes = {}
    for order in (turns, turns[::-1]):
        for name, f in order:
            ctimes.setdefault(name, []).append(1e3 * cs.cuda_ms(f, iters=100))
    empty = 1e3 * cs.cuda_ms(lambda: sg.empty_launch(dev), iters=200)

    cs.log(f"times in us, in turns (there and back); an empty launch {empty:.2f} us")
    for r in rows:
        cs.log(f"{r['shape']}: {r['variant']:11s} blocks/SM {r['blocks_per_sm']} "
               f"cap {r['max_px']:2d} -> {r['px_per_thread']:2d} px a thread, "
               f"{r['strips']:3d} strips: "
               + " ".join(f"{x:.2f}" for x in r["us"]))
    for name, us in ctimes.items():
        cs.log(f"gate, {name}: " + " ".join(f"{x:.2f}" for x in us))
    cs.log(smi)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as fh:
            json.dump(dict(card=smi, empty_launch_us=empty, ptxas=report,
                           rows=rows, cluster=ctimes), fh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
