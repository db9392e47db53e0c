"""Decoder weights side by side on the GPU: each network's held-out depth
quality on the training recipe's validation views, and a facade run served
by each.

For every ``PREFIX`` given (``PREFIX.json`` + ``PREFIX.pkl``, e.g.
data/nets/room256_32v4 and the output of
``python -m deepfactors_tpu_torch.train_room_decoder``):
  - ``train_room_decoder.evaluate`` on the recipe's validation set
    (``build_dataset(--val-rooms, 16, seed 99991)``, domain-randomised as
    ``--randomize`` renders it; the JAX tool's views): depth RMSE at the zero,
    predicted and optimal code, prox RMSE at the zero and predicted code;
  - chip_smoke.py's phase 4 configuration (the sequential facade with
    reprojection factors on, a window of 32) on the first ``--frames``
    frames of room ``--scene-seed``'s orbit: tracked fraction, keyframes,
    rigid ATE.
Prints one line per network and a JSON line of all of it.

    python3 port_tools/compare_trained.py data/nets/room256_32v4 \
        build/nets/room256_port [--frames 60] [--val-rooms 8]
"""
import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("prefixes", nargs="+")
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--scene-seed", type=int, default=7)
    ap.add_argument("--val-rooms", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("compare_trained: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from deepfactors_tpu_torch import train_room_decoder as trd
    from deepfactors_tpu_torch.models.decoder import load_decoder

    dev = args.device
    smi = cs.smi_line() if dev == "cuda" else "cpu"
    print(smi, flush=True)
    if dev == "cuda":
        from deepfactors_tpu_torch.ops.kernels import build
        build.build_all()
    imgs, dpts = trd.build_dataset(args.val_rooms, 16, cs.H, cs.W,
                                   cs._smoke_camera(), seed=99991,
                                   randomize=True, device=dev)
    rows = []
    for prefix in args.prefixes:
        dec = load_decoder(prefix, device=dev)
        v = trd.evaluate(dec, imgs, dpts)
        r = cs.run_facade(dev, dec, os.path.basename(prefix),
                          scene_seed=args.scene_seed, n_frames=args.frames,
                          max_keyframes=32, max_factors=128,
                          use_reprojection=True, time_parts=False)
        row = {"network": prefix, "val_frames": int(imgs.shape[0]),
               "depth_rmse_zero": float(v[0]), "depth_rmse_pred": float(v[1]),
               "depth_rmse_opt": float(v[5]), "prox_rmse_zero": float(v[2]),
               "prox_rmse_pred": float(v[3]), "tracked": float(r["tracked"]),
               "lost": int(r["df"].n_lost_frames),
               "keyframes": int(r["df"].mapper._next_kid), "ate_m": r["ate"]}
        rows.append(row)
        print(f"{prefix}: held-out depth RMSE zero / pred / opt code "
              f"{v[0]:.4f} / {v[1]:.4f} / {v[5]:.4f} m, prox RMSE zero / "
              f"pred {v[2]:.4f} / {v[3]:.4f}; {args.frames} frames of room "
              f"{args.scene_seed}: tracked {r['tracked']:.4f}, "
              f"{row['keyframes']} keyframes, ATE {r['ate']:.4f} m; {smi}",
              flush=True)
    print(json.dumps({"device": smi, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
