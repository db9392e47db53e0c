"""One run of the port's sequential facade on the synthetic room orbit, on
the GPU, with the scene, length and keyframe window given on the command
line: chip_smoke.py's end-to-end runner (``run_facade``) outside its fixed
phases. Prints the readings chip_smoke.py prints for a phase (latencies by
event kind, evictions, keyframes, tracked fraction, rigid ATE, ATE every 20
frames, kernel launches), then one JSON line. A lost frame ends the run with
the facade's ``NotImplementedError`` (relocalisation is not ported).
``--use-reprojection`` switches the reprojection factors on (the mapper's
default configuration; chip_smoke.py's phase 4) and adds their readings.

The counterpart on the CPU for the JAX package, with the same arguments, is
``port_tools/jax_smoke_reference.py``.

Run from the repository root on a machine with a GPU:
    python3 port_tools/facade_run.py --scene-seed 5 --frames 180 \\
        --max-keyframes 16 --max-factors 64 [--repeat 2] [--use-reprojection]
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene-seed", type=int, default=7)
    # the one-way-frame policy's distance (0.12 in every configuration of
    # chip_smoke.py); other values probe how far a run depends on one
    # decision falling a frame earlier or later
    ap.add_argument("--frame-dist-threshold", type=float, default=0.12)
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--max-keyframes", type=int, default=32)
    ap.add_argument("--max-factors", type=int, default=128)
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--use-reprojection", action="store_true")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("facade_run: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from deepfactors_tpu_torch.models.decoder import load_decoder
    from deepfactors_tpu_torch.ops.kernels import build

    smi = cs.smi_line()
    print(smi, flush=True)
    build.build_all()
    dec = load_decoder(os.path.join(ROOT, "data", "nets", "room256_32v4"),
                       device="cuda")
    for rep in range(args.repeat):
        r = cs.run_facade("cuda", dec, f"run {rep}", args.scene_seed,
                          args.frames, args.max_keyframes, args.max_factors,
                          frame_dist_threshold=args.frame_dist_threshold,
                          use_reprojection=args.use_reprojection)
        df = r["df"]
        print(json.dumps({
            "device": smi, "scene_seed": args.scene_seed,
            "frames": args.frames, "max_keyframes": args.max_keyframes,
            "frame_dist_threshold": args.frame_dist_threshold,
            "use_reprojection": args.use_reprojection,
            "n_rep_factors_live": int(df.mapper.rep_pool.active.sum())
            if args.use_reprojection else 0,
            "ate_m": r["ate"], "tracked_fraction": r["tracked"],
            "n_keyframes_built": df.mapper._next_kid,
            "n_evictions": df.n_evictions,
            "ate_keyframes_evictions_at": r["ate_at"],
            "launches": cs.launch_counts()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
