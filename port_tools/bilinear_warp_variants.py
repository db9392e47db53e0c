"""Time design variants of bilinear_warp_planes (csrc/dense_warp.cu) in
turns, inside one process on one card: what its design was chosen against.

Each variant is csrc/dense_warp.cu with one change made by text
substitution, built by nvcc with the port's flags into ``--out``:
  - final: the source as it is (C = 1..4 at compile time, all 4C gathers
    of a thread issued before its first store, Hopper's programmatic
    dependent launch: cudaLaunchKernelEx with
    cudaLaunchAttributeProgrammaticStreamSerialization, and the kernel waits
    (griddepcontrol.wait) before its first global access, so its launch
    overlaps the tail of the kernel before it on the stream);
  - no_pdl: a plain <<<...>>> launch and no wait, the rest unchanged;
  - runtime_c: every C through the general loop (C at run time, one plane
    after the other), the rest unchanged;
plus two committed sources:
  - ppt2, ppt4: port_tools/variants/bilinear_warp_ppt.cu, the final design
    at 2 and 4 consecutive pixels a thread (coordinates read and outputs
    stored as float2/float4 where aligned);
  - first: the first design (port_tools/variants/bilinear_warp_first.cu:
    one pixel a thread, C at run time, planes stacked by the caller).

Every variant is held against the plain twin at C = 3 (bit-identical, NaN
in the same places) at chip_smoke.py's sampling inputs (a perturbed factor
of a rendered room, rows 0 and 1 at tptz ~ 0). Then two timings, each in
turns there and back with chip_smoke.cuda_ms:
  - the kernel alone, C = 3, at 192x256 / 96x128 / 48x64 (back-to-back
    launches: a dependent launch overlaps its own predecessor here; the
    first design's kernel on planes stacked beforehand);
  - in context at 192x256: the sampling stage of ``sfm_step`` after the two
    PyTorch kernels that write its coordinates (``+ u0``, ``+ v0``), the
    first design with the caller's torch.stack of the planes, the others
    reading img1 and the interleaved gradient [H, W, 2] in place.
Printed with the card's name and power limit and an empty launch's time.

Run from the repository root on a machine with a GPU:
    python3 port_tools/bilinear_warp_variants.py [--out build/variants_bwp] [--json PATH]
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

DISPATCH = "  switch (C) {"
PLAIN_LAUNCH = """  kern<<<nblk, kThreads, 0, stream>>>(args...);
  return cudaGetLastError();"""
PDL_LAUNCH = """  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nblk);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, args...);"""
PDL_WAIT = '  asm volatile("griddepcontrol.wait;" ::: "memory");\n'
VARIANTS = ("final", "no_pdl", "runtime_c")
# variant -> pixels a thread, for those built from bilinear_warp_ppt.cu
PPT_VARIANTS = {"ppt2": 2, "ppt4": 4}


def sources(csrc):
    """{variant: source text} from csrc/dense_warp.cu."""
    src = open(os.path.join(csrc, "dense_warp.cu")).read()
    for old in (DISPATCH, PDL_LAUNCH, PDL_WAIT):
        assert src.count(old) == 1, f"dense_warp.cu no longer holds {old!r}"
    return {"final": src,
            "no_pdl": src.replace(PDL_LAUNCH, PLAIN_LAUNCH).replace(
                PDL_WAIT, ""),
            "runtime_c": src.replace(DISPATCH, "  switch (0) {")}


def build_all(out, build, csrc):
    """Build every variant and the first design, one nvcc each, all started
    together; returns ({name: C launcher}, {name: ptxas lines})."""
    procs = []
    for name, text in sources(csrc).items():
        d = os.path.join(out, name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "dense_warp.cu"), "w") as fh:
            fh.write(text)
        procs.append((name, os.path.join(d, "lib.so"),
                      os.path.join(d, "dense_warp.cu")))
    variants = os.path.join(ROOT, "port_tools", "variants")
    for name in PPT_VARIANTS:
        procs.append((name, os.path.join(out, f"{name}.so"),
                      os.path.join(variants, "bilinear_warp_ppt.cu")))
    procs.append(("first", os.path.join(out, "first.so"),
                  os.path.join(variants, "bilinear_warp_first.cu")))
    running = [(name, lib, subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas=-v", "-I", str(csrc),
         "-o", lib, src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)) for name, lib, src in procs]
    fns, report = {}, {}
    for name, lib, proc in running:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{text}")
        report[name] = [ln.strip() for ln in text.splitlines()
                        if "Compiling entry" in ln or "registers" in ln
                        or "spill" in ln]
        so = ctypes.CDLL(lib)
        if name == "first":
            fn = so.bilinear_warp_first_launch
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                           + [ctypes.c_void_p])
        else:
            fn = so.bilinear_warp_launch
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                           + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns, report


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "variants_bwp"))
    ap.add_argument("--json", default=None)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("bilinear_warp_variants: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from deepfactors_tpu_torch.geometry.camera import camera_pyramid
    from deepfactors_tpu_torch.ops.kernels import build
    from deepfactors_tpu_torch.ops.kernels import dense_warp as dw
    from deepfactors_tpu_torch.ops.kernels import sfm_gram as sg

    dev = "cuda"
    smi = cs.smi_line()
    cs.log(smi)
    build.build_all()
    fns, report = build_all(args.out, build, build.CSRC)
    for name, lines in report.items():
        cs.log(f"{name}: " + "; ".join(lines))
    p = sg._ptr
    stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def plan(name, H, W):
        """(px_per_blk, nblk): launch_plan's for one pixel a thread, the
        same rule at the ppt variants' pixel counts."""
        if name not in PPT_VARIANTS:
            pl = sg.launch_plan("bilinear_warp_planes", 1, H, W)
            return pl.px_per_blk, pl.nblk
        per = sg.THREADS * PPT_VARIANTS[name]
        return per, -(-H * W // per)

    def sampler(name, img1, grad1, x1, y1, stacked=None):
        """The variant's call on img1 and grad1's two channels in place; the
        first design's on ``stacked`` planes if given, else its stage (the
        stack, then its kernel)."""
        H, W = img1.shape
        if name == "first" and stacked is not None:
            return lambda: cs.first_design_kernel(fns["first"], stacked, x1,
                                                  y1)
        if name == "first":
            return lambda: cs.first_design_stage(fns["first"], img1, grad1,
                                                 x1, y1)
        per, nblk = plan(name, H, W)
        ptrs = (ctypes.c_void_p * 3)(img1.data_ptr(), grad1.data_ptr(),
                                     grad1.data_ptr() + 4)
        strides = (ctypes.c_int * 3)(1, 2, 2)

        def f():
            out = torch.empty((3, H, W), device=dev)
            code = fns[name](ptrs, strides, p(x1), p(y1), p(out), 3, H, W,
                             per, nblk, stream())
            assert code == 0, code
            return out
        return f

    K = 32
    cam, levels, q, t, _ = cs.make_pools(dev, K=K, CS=32)
    cams = camera_pyramid(cam, 3)
    configs = ["first", *VARIANTS, *PPT_VARIANTS]
    rows = []
    for l, lv in enumerate(levels):
        img1, grad1, x1, y1 = cs.bilinear_case(dev, K, lv, cams[l], q, t,
                                               60 + l)
        stacked = torch.stack([img1, grad1[..., 0], grad1[..., 1]])
        twin = dw.bilinear_warp_planes_plain(stacked, x1, y1)
        calls = {}
        for name in configs:
            f = sampler(name, img1, grad1, x1, y1, stacked)
            out = f()
            torch.cuda.synchronize()
            nan = torch.isnan(twin)
            assert torch.equal(torch.isnan(out), nan), name
            assert torch.equal(out[~nan], twin[~nan]), name
            calls[name] = f
        times = {}
        for order in (configs, configs[::-1]):
            for key in order:
                times.setdefault(key, []).append(
                    1e3 * cs.cuda_ms(calls[key], iters=100))
        size = f"{img1.shape[0]}x{img1.shape[1]}"
        for name, us in times.items():
            rows.append(dict(timing="kernel alone, C=3", shape=size,
                             variant=name, us=us))
        if l != 0:
            continue
        # in context: the two PyTorch kernels that write the coordinates,
        # then the sampling stage
        h, w = img1.shape
        u0, v0 = cams[0].u0, cams[0].v0
        xr, yr = x1 - u0, y1 - v0
        bx, by = torch.empty_like(x1), torch.empty_like(y1)
        adds = lambda: (torch.add(xr, u0, out=bx), torch.add(yr, v0, out=by))

        def stage(name):
            f = sampler(name, img1, grad1, bx, by)
            return lambda: (adds(), f())[1]
        stages = {name: stage(name) for name in configs}
        ref = stages["first"]()
        for name, g in stages.items():
            o = g()
            torch.cuda.synchronize()
            nan = torch.isnan(ref)
            assert torch.equal(o[~nan], ref[~nan]), name
        ctimes = {}
        for order in (configs, configs[::-1]):
            for key in order:
                ctimes.setdefault(key, []).append(
                    1e3 * cs.cuda_ms(stages[key], iters=100))
        t_adds = 1e3 * cs.cuda_ms(adds, iters=100)
        for name, us in ctimes.items():
            rows.append(dict(timing="in context: two coordinate adds, then "
                             "the sampling stage", shape=f"{h}x{w}",
                             variant=name, us=us))
        rows.append(dict(timing="the two coordinate adds alone",
                         shape=f"{h}x{w}", variant="-", us=[t_adds]))

    empty = 1e3 * cs.cuda_ms(lambda: sg.empty_launch(dev), iters=200)
    cs.log(f"times in us, in turns (there and back); an empty launch "
           f"{empty:.2f} us")
    for r in rows:
        cs.log(f"{r['timing']} {r['shape']}: {r['variant']:10s} "
               + " ".join(f"{x:.2f}" for x in r["us"]))
    cs.log(smi)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as fh:
            json.dump(dict(card=smi, empty_launch_us=empty, ptxas=report,
                           rows=rows), fh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
