"""Dataset directories for the demo entry, written on the host.

Renders the synthetic room orbit of ``chip_smoke.py``'s end-to-end phase
(``random_room(7, n_boxes=3)``, the first frames of
``orbit_trajectory(300, sweep=3.2*pi)``) with the port's renderer on the
CPU, quantises each frame to 8-bit gray and writes it through the port's
PNG codec (``io/image_io.py``), in one of two layouts:

  - ``tum``: TUM RGB-D's layout at 640x480, rendered at TUM's default
    intrinsics (``io/drivers.TumInterface.DEFAULT_INTRINSICS``):
    ``rgb/<ts>.png``, ``rgb.txt`` and ``groundtruth.txt`` (``ts tx ty tz
    qx qy qz qw``, camera-to-world), timestamps i/30 s;
  - ``files``: a plain directory of ``<i>.png`` at 320x240, rendered at the
    ``files://`` driver's pinhole guess (focal 0.8 W, centred), no ground
    truth.

Prints the directory's sha256 (names and contents, sorted), so that a run
elsewhere can check it reads the same frames. Run from the repository root:
  python port_tools/demo_data.py tum build/demo_tum [--frames 60]
  python port_tools/demo_data.py files build/demo_files [--frames 30]
"""
from __future__ import annotations

import argparse
import hashlib
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SCENE_SEED = 7
SEQ_LEN = 300
SWEEP = 3.2 * np.pi


def _render(width: int, height: int, fx, fy, u0, v0, n_frames: int,
            scene_seed: int = SCENE_SEED):
    """(u8 gray frames, camera-to-world poses) of the orbit, on the CPU."""
    from deepfactors_tpu_torch.geometry.camera import PinholeCamera
    from deepfactors_tpu_torch.io import synth

    cam = PinholeCamera.create(fx=fx, fy=fy, u0=u0, v0=v0, width=width,
                               height=height)
    scene = synth.random_room(scene_seed, n_boxes=3)
    poses = synth.orbit_trajectory(SEQ_LEN, sweep=SWEEP)[:n_frames]
    frames = synth.render_sequence(scene, cam, poses, height, width,
                                   device="cpu")
    u8 = [(np.clip(f, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
          for f in frames]
    return u8, poses


def dir_sha256(path: str) -> str:
    h = hashlib.sha256()
    for root, _, files in sorted(os.walk(path)):
        for name in sorted(files):
            p = os.path.join(root, name)
            h.update(os.path.relpath(p, path).encode())
            with open(p, "rb") as f:
                h.update(f.read())
    return h.hexdigest()


def write_tum(out_dir: str, n_frames: int = 60,
              scene_seed: int = SCENE_SEED) -> str:
    """The TUM layout at 640x480; returns the directory's sha256."""
    from deepfactors_tpu_torch.io import image_io
    from deepfactors_tpu_torch.io.drivers import TumInterface

    fx, fy, u0, v0, W, H = TumInterface.DEFAULT_INTRINSICS
    frames, poses = _render(W, H, fx, fy, u0, v0, n_frames, scene_seed)
    os.makedirs(os.path.join(out_dir, "rgb"), exist_ok=True)
    rgb, gt = ["# color images\n"], ["# ground truth trajectory\n"]
    for i, (img, p) in enumerate(zip(frames, poses)):
        ts = f"{i / 30.0:.6f}"
        image_io.imwrite(os.path.join(out_dir, "rgb", f"{ts}.png"), img)
        rgb.append(f"{ts} rgb/{ts}.png\n")
        q, t = np.asarray(p.q, np.float64), np.asarray(p.t, np.float64)
        gt.append(f"{ts} {t[0]:.7f} {t[1]:.7f} {t[2]:.7f} "
                  f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}\n")
    with open(os.path.join(out_dir, "rgb.txt"), "w") as f:
        f.writelines(rgb)
    with open(os.path.join(out_dir, "groundtruth.txt"), "w") as f:
        f.writelines(gt)
    return dir_sha256(out_dir)


def write_files(out_dir: str, n_frames: int = 30, width: int = 320,
                height: int = 240, scene_seed: int = SCENE_SEED):
    """The plain layout; returns (sha256, the u8 frames written)."""
    from deepfactors_tpu_torch.io import image_io

    f = 0.8 * width
    frames, _ = _render(width, height, f, f, width / 2, height / 2,
                        n_frames, scene_seed)
    os.makedirs(out_dir, exist_ok=True)
    for i, img in enumerate(frames):
        image_io.imwrite(os.path.join(out_dir, f"{i:04d}.png"), img)
    return dir_sha256(out_dir), frames


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("layout", choices=("tum", "files"))
    ap.add_argument("out_dir")
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--scene-seed", type=int, default=SCENE_SEED)
    a = ap.parse_args(argv)
    if a.layout == "tum":
        sha = write_tum(a.out_dir, a.frames or 60, a.scene_seed)
    else:
        sha, _ = write_files(a.out_dir, a.frames or 30,
                             scene_seed=a.scene_seed)
    print(f"{a.layout} {a.out_dir} sha256 {sha}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
