"""Where the time goes in the port's end-to-end run on the GPU.

Runs one of chip_smoke.py's full-width phases at 192x256 with the
room256_32v4 decoder (the sequential facade on the synthetic room orbit: 60
frames in a window of 32 keyframes, or with ``--long`` the 180 frames in a
window of 16 that evict, with the map dump and warp render after them; with
``--phase large_map`` the 10 BA iterations over 32 keyframes and 236
factors, with ``--phase odometry`` the 30 lockstep frames over 8 rooms,
each without its set-up) once to warm up, then again under
``torch.profiler`` with CUDA activity only, and prints:
  - the run's wall time and the device's busy time (the union of all
    kernel and copy intervals), hence the device's idle share;
  - the device time by kernel name (count, total, mean), largest first.

Run from the repository root on a machine with a GPU:
    python3 port_tools/profile_e2e.py [--long | --phase NAME] [--top 25] [--json PATH]
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--json", default=None)
    ap.add_argument("--long", action="store_true")
    ap.add_argument("--phase", default=None,
                    choices=("large_map", "odometry"))
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
    else:
        run = cs.phase_long_run if name == "long" else cs.phase_e2e
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
