"""Where the time goes in the port's end-to-end run on the GPU.

Runs one of chip_smoke.py's full-width phases at 192x256 with the
room256_32v4 decoder (the sequential facade on the synthetic room orbit: 60
frames in a window of 32 keyframes with reprojection factors on, or with
``--long`` the 180 frames in a window of 16 that evict, reprojection off,
with the map dump and warp render after them; with
``--phase large_map`` the 10 BA iterations over 32 keyframes and 236
factors, with ``--phase odometry`` the 30 lockstep frames over 8 rooms,
with ``--phase loop`` the 186 frames of the flagship configuration with
loop closure on, with ``--phase reloc`` the relocalisation run (two noise
frames, a recovery against the live pool and one against the archive),
with ``--phase rep_ops`` one keyframe event's reprojection work at the
main path's shapes: detect_pyramid on one 192x256 frame, match + RANSAC
both ways of one pair (128 hypotheses), and the rep system of 32 factors
with its assembly, with ``--phase pipelined`` phase 8's run, bench.py's
end-to-end row through the pipelined facade (300 frames of room 7 at
``pipeline_depth=1``, its prewarm and rendering included; no sync audit,
no upload or probe check);
each without its set-up) once to warm up, then again under
``torch.profiler`` with CUDA activity only, and prints:
  - the run's wall time and the device's busy time (the union of all
    kernel and copy intervals), hence the device's idle share;
  - the device time by kernel name (count, total, mean), largest first.

Run from the repository root on a machine with a GPU:
    python3 port_tools/profile_e2e.py [--long | --phase NAME] [--top 25]
        [--json PATH]
``--json`` also writes the numbers to PATH.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def busy_us(intervals):
    """Length of the union of [start, end) intervals (microseconds)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def rep_ops_problem(cs, dev="cuda"):
    """The reprojection work of one keyframe event on the card (frames
    ``cs.REP_FRAMES`` of room 7), as one callable."""
    import numpy as np
    import torch
    from deepfactors_tpu_torch.features import detector as det
    from deepfactors_tpu_torch.features import matching as mt
    from deepfactors_tpu_torch.geometry import se3 as se3m
    from deepfactors_tpu_torch.geometry.camera import PinholeCamera
    from deepfactors_tpu_torch.io import synth
    from deepfactors_tpu_torch.ops import image as ip
    from deepfactors_tpu_torch.ops import sparse_factors as sf
    from deepfactors_tpu_torch.solver import system as sysm

    H, W, CS, K, P = cs.H, cs.W, 32, 32, 32
    cam = PinholeCamera.create(fx=220.0, fy=220.0, u0=W / 2, v0=H / 2,
                               width=W, height=H)
    poses = synth.orbit_trajectory(cs.SEQ_LEN, sweep=3.2 * np.pi)
    frames = synth.render_sequence(synth.random_room(7, n_boxes=3), cam,
                                   [poses[i] for i in cs.REP_FRAMES], H, W,
                                   device=dev)
    pyr = [ip.build_pyramid(torch.as_tensor(np.asarray(f), device=dev), 3)
           for f in frames]
    dcfg = det.DetectorConfig(max_keypoints=128)
    f0, f1 = (det.detect_pyramid(p, dcfg) for p in pyr)
    gen = torch.Generator(device=dev).manual_seed(42)
    g = torch.Generator(device=dev).manual_seed(0)
    ident = se3m.identity((P,), device=dev)
    rep = (ident, se3m.retract(ident, 0.01 * torch.randn(
        P, 6, device=dev, generator=g)),
        torch.zeros((P, CS), device=dev), cam,
        torch.rand((P, 128, 2), device=dev, generator=g) * 150 + 40,
        torch.rand((P, 128, 2), device=dev, generator=g) * 150 + 40,
        torch.ones((P, 128), dtype=torch.bool, device=dev),
        torch.full((K, H, W), 0.5, device=dev),
        0.01 * torch.randn((K, CS, H, W), device=dev, generator=g))
    src = torch.arange(P, device=dev) % K
    idx = sysm.factor_slot_indices(src, (src + 1) % K, K, CS)
    act = torch.ones(P, dtype=torch.bool, device=dev)

    def run():
        det.detect_pyramid(pyr[0], dcfg)
        D0 = torch.stack([f0.descriptor, f1.descriptor])
        D1 = torch.stack([f1.descriptor, f0.descriptor])
        m = mt.match(D0, torch.stack([f0.valid, f1.valid]), D1,
                     torch.stack([f1.valid, f0.valid]), max_dist=30)
        xy1 = torch.gather(torch.stack([f1.xy, f0.xy]), 1,
                           m.idx1.long()[..., None].expand(-1, -1, 2))
        mt.prune_matches_eight_point(
            torch.stack([f0.xy, f1.xy]), xy1, m.valid, cam,
            idx=mt.draw_hypotheses(m.valid, 128, gen))
        r = sf.reprojection_system(*rep, src=src)
        sysm.assemble(K * (6 + CS), r.JtJ, r.Jtr, idx, act)
    return run


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--json", default=None)
    ap.add_argument("--long", action="store_true")
    ap.add_argument("--phase", default=None,
                    choices=("large_map", "odometry", "rep_ops", "loop",
                             "reloc", "pipelined"))
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_e2e: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from deepfactors_tpu_torch.models.decoder import load_decoder
    from deepfactors_tpu_torch.ops.kernels import build

    smi = cs.smi_line()
    print(smi, flush=True)
    build.build_all()
    dec = load_decoder(os.path.join(ROOT, "data", "nets", "room256_32v4"),
                       device="cuda")
    name = args.phase or ("long" if args.long else "e2e")
    if name == "large_map":
        setup = cs.large_map_setup("cuda", dec)
        phase = lambda: cs.large_map_run(setup)
    elif name == "odometry":
        setup = cs.odometry_setup("cuda")
        phase = lambda: cs.odometry_run(setup)
    elif name == "rep_ops":
        phase = rep_ops_problem(cs)
    elif name == "pipelined":
        phase = lambda: cs.run_pipelined("cuda", dec, "pipelined", audit=None,
                                         checks=False)
    else:
        run = {"long": cs.phase_long_run, "loop": cs.phase_loop,
               "reloc": cs.phase_reloc}.get(name, cs.phase_e2e)
        phase = lambda: run("cuda", dec)
    phase()                                         # warm-up run
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        phase()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = busy_us([(e.time_range.start, e.time_range.end)
                    for e in dev_events])
    by_name = {}
    for e in dev_events:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + (e.time_range.end - e.time_range.start))
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    out = {
        "device": smi,
        "wall_ms": wall_us / 1e3,
        "device_busy_ms": busy / 1e3,
        "device_idle_share": 1.0 - busy / wall_us,
        "n_device_events": len(dev_events),
        "kernels": [{"name": n[:120], "count": c, "total_ms": t / 1e3,
                     "mean_us": t / c} for n, (c, t) in rows[:args.top]],
    }
    print(f"profiled {name}: wall {out['wall_ms']:.1f} ms, device busy "
          f"{out['device_busy_ms']:.1f} ms, idle share "
          f"{out['device_idle_share']:.4f}, {len(dev_events)} device events")
    for k in out["kernels"]:
        print(f"  {k['total_ms']:10.3f} ms  {k['count']:7d} x "
              f"{k['mean_us']:9.2f} us  {k['name']}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
