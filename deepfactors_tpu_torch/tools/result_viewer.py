"""result_viewer: headless inspection of a run directory.

PyTorch port of the JAX package's ``tools/result_viewer.py`` (the
reference's sources/tools/result_viewer.cpp is a GT trajectory and depth
reprojection viewer; here: the trajectory plot, a depth colormap per
keyframe and a point cloud of the saved keyframes). Writes into
``<run_dir>/viewer`` (or ``--out``): ``kf_<id>_depth_color.png`` (the
port's turbo table, ``viz.apply_colormap``, written BGR as the reference's
``cv2.imwrite`` writes it), ``map.ply`` and ``trajectory.png``.

``trajectory.png`` needs matplotlib. Where it does not import, the viewer
writes everything else and prints one line saying that the plot was not
written and why. The PNGs go through ``io/image_io``; no device is touched
(``--device``, default cuda, is checked like every entry's).

Usage: python -m deepfactors_tpu_torch.tools.result_viewer <run_dir>
       [--out dir] [--device cpu]
"""
from __future__ import annotations

import glob
import os
import sys

import numpy as np

from ..config import parse_args
from ..io import image_io
from ..utils import tum_io
from ..viz import apply_colormap, plot_trajectory, save_ply
from .common import device_from_flag


def main(argv) -> int:
    flags = parse_args(list(argv))
    device_from_flag(flags.get("device", "cuda"))
    pos = flags.get("__positional__", [])
    if not pos:
        print("usage: python -m deepfactors_tpu_torch.tools.result_viewer "
              "<run_dir>")
        return 1
    run_dir = pos[0]
    out = flags.get("out", os.path.join(run_dir, "viewer"))
    os.makedirs(out, exist_ok=True)

    traj_file = os.path.join(run_dir, "trajectory.txt")
    if os.path.exists(traj_file):
        traj = tum_io.load_trajectory(traj_file)
        try:
            import matplotlib  # noqa: F401
        except ImportError as e:
            print(f"trajectory: {len(traj)} poses; trajectory.png NOT "
                  f"written: matplotlib does not import ({e})")
        else:
            plot_trajectory(os.path.join(out, "trajectory.png"), traj)
            print(f"trajectory: {len(traj)} poses -> trajectory.png")

    intr = os.path.join(run_dir, "intrinsics.txt")
    fx = fy = u0 = v0 = None
    if os.path.exists(intr):
        fx, fy, u0, v0 = np.loadtxt(intr)[:4]

    all_xyz, all_rgb = [], []
    for dpt_file in sorted(glob.glob(os.path.join(run_dir, "kf_*_dpt.png"))):
        kid = os.path.basename(dpt_file).split("_")[1]
        dpt = image_io.imread(dpt_file, "any_depth").astype(np.float32) \
            / 5000.0
        image_io.imwrite(os.path.join(out, f"kf_{kid}_depth_color.png"),
                         apply_colormap(dpt)[..., ::-1])
        img_file = os.path.join(run_dir, f"kf_{kid}_img.png")
        if fx is not None and os.path.exists(img_file):
            img = image_io.imread(img_file, "gray")
            H, W = dpt.shape
            ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
            z = dpt
            keep = (z > 0.05).reshape(-1)
            pts = np.stack([(xs - u0) / fx * z, (ys - v0) / fy * z, z],
                           axis=-1).reshape(-1, 3)[keep]
            rgb = np.stack([img] * 3, axis=-1).reshape(-1, 3)[keep]
            all_xyz.append(pts)
            all_rgb.append(rgb)
    if all_xyz:
        save_ply(os.path.join(out, "map.ply"),
                 np.concatenate(all_xyz), np.concatenate(all_rgb))
        print(f"point cloud: {sum(len(x) for x in all_xyz)} pts -> map.ply")
    print(f"viewer output in {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
