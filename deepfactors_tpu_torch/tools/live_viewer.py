"""live_viewer: watch a run WHILE it happens.

PyTorch port of the JAX package's ``tools/live_viewer.py``. The reference
GUI renders the map live during the run (sources/gui/visualizer.h:81-177);
here a ``LiveViewer`` attaches to a sequential ``DeepFactors`` facade
through its keyframe and pose callbacks (deepfactors.h:114-116), chaining
any callbacks already set, and at every keyframe event (plus a trajectory
tick every ``every`` frames) writes the new keyframe's image and depth into
a run directory and rebuilds a self-contained ``viewer.html``
(``replay_viewer.build_html``) with an auto-refresh tag: open it in a
browser and watch the map grow.

Device reads: ONE packed ``torch.stack([img, dpt]).cpu()`` per new
keyframe, and one read of the live keyframes' (ids, pose.q, pose.t) per
trajectory write; an archived keyframe's pose is read once, at the first
write after its eviction. The HTML rebuild is host work. The viewer runs
on the sequential facade: in pipelined mode its reads would synchronise
every dispatch.

Usage (in-process):
    from deepfactors_tpu_torch.tools.live_viewer import LiveViewer
    lv = LiveViewer("/tmp/live_run", df)   # attaches callbacks
    ... df.process_frame(...) loop ...
    lv.finish()                            # final page, callbacks detached
"""
from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ..geometry.se3 import SE3
from ..io import image_io
from ..utils import tum_io
from . import replay_viewer as rv


class LiveViewer:
    def __init__(self, run_dir: str, df, every: int = 5, stride: int = 3,
                 max_depth: float = 8.0):
        self.run_dir = run_dir
        self.df = df
        self.every = max(1, every)
        self.stride = stride
        self.max_depth = max_depth
        os.makedirs(run_dir, exist_ok=True)
        self._n = 0
        self._written = set()
        self._archived = []          # host (id, SE3) of archived keyframes
        # chain (don't replace) any existing callbacks
        self._prev_map_cb = df.map_callback
        self._prev_pose_cb = df.pose_callback
        df.map_callback = self._on_map
        df.pose_callback = self._on_pose
        with open(os.path.join(run_dir, "intrinsics.txt"), "w") as f:
            f.write(f"{float(df.cam.fx)} {float(df.cam.fy)} "
                    f"{float(df.cam.u0)} {float(df.cam.v0)}\n")

    # -- callbacks ---------------------------------------------------------
    def _on_pose(self, pose):
        if self._prev_pose_cb:
            self._prev_pose_cb(pose)
        self._n += 1
        if self._n % self.every == 0:
            self._write_trajectory()
            self._rebuild(refresh=2.0)

    def _on_map(self, state):
        if self._prev_map_cb:
            self._prev_map_cb(state)
        self._dump_new_keyframes()
        self._write_trajectory()
        self._rebuild(refresh=2.0)

    # -- IO ----------------------------------------------------------------
    def _dump_new_keyframes(self):
        """ONE packed device read per new keyframe: [2, H, W] = img | dpt."""
        m = self.df.mapper
        lvl = m.state.levels[0]
        for kid, slot in sorted(m.kf_ids.items()):
            if kid in self._written:
                continue
            packed = torch.stack([lvl.img[slot], lvl.dpt[slot]]).cpu().numpy()
            img, dpt = packed[0], packed[1]
            image_io.imwrite(os.path.join(self.run_dir, f"kf_{kid}_img.png"),
                             (np.clip(img, 0, 1) * 255).astype(np.uint8))
            image_io.imwrite(os.path.join(self.run_dir, f"kf_{kid}_dpt.png"),
                             (np.clip(dpt, 0, 13) * 5000).astype(np.uint16))
            self._written.add(kid)

    def _write_trajectory(self):
        tum_io.save_trajectory(
            os.path.join(self.run_dir, "trajectory.txt"),
            self.df.trajectory)
        m = self.df.mapper
        for a in m.archived[len(self._archived):]:
            qt = torch.cat([a["q"], a["t"]]).cpu().numpy()
            self._archived.append((float(a["id"]), SE3(qt[:4], qt[4:])))
        kf_poses = list(self._archived)
        if m.kf_slots:
            st = m.state
            # one read: [K, 8] = id | q | t
            packed = torch.cat([st.ids.to(torch.float32)[:, None],
                                st.pose.q, st.pose.t], dim=1).cpu().numpy()
            for s in m.kf_slots:
                kf_poses.append((float(packed[s, 0]),
                                 SE3(packed[s, 1:5], packed[s, 5:8])))
        kf_poses.sort(key=lambda x: x[0])
        tum_io.save_trajectory(
            os.path.join(self.run_dir, "keyframes.txt"), kf_poses)

    def _rebuild(self, refresh: float = 0.0):
        run = rv.load_run(self.run_dir)
        if not run["kf_files"]:
            return
        html = rv.build_html(run, self.stride, self.max_depth)
        if refresh > 0:
            html = html.replace(
                "<meta charset=\"utf-8\">",
                "<meta charset=\"utf-8\">"
                f"<meta http-equiv=\"refresh\" content=\"{refresh}\">")
        tmp = os.path.join(self.run_dir, ".viewer.tmp")
        with open(tmp, "w") as f:
            f.write(html)
        os.replace(tmp, os.path.join(self.run_dir, "viewer.html"))

    def finish(self):
        """Final rebuild without the auto-refresh tag; detach callbacks."""
        self._dump_new_keyframes()
        self._write_trajectory()
        self._rebuild(refresh=0.0)
        self.df.map_callback = self._prev_map_cb
        self.df.pose_callback = self._prev_pose_cb


if __name__ == "__main__":
    print(__doc__)
    sys.exit(0)
