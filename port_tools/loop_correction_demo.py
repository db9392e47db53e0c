"""Loop-closure correction magnitude with the PyTorch port: the counterpart of
``tools/loop_correction_demo.py``.

Builds a window of 8 keyframes along a 0.3pi orbit of ``random_room(7)``
at 96x128 with the ground-truth 'decoder' (``io/synth.OracleDecoder``) and
reprojection factors on, INJECTS a drift into the newest keyframe's pose
(0.3 m along x and 0.1 rad of yaw by default: the accumulated drift a loop
closure must remove), then closes the loop three ways and measures the
share of the injected pose error each removes:

  1. archived-prior path: ``Mapper.add_loop_prior`` at the true pose
     (sigma 0.05, the facade's ``loop_sigma``), fresh photometric works to
     the newest back-connection, mapping to an empty work list: what the
     facade does for a loop against an archived keyframe;
  2. live-loop path: the same prior plus ``enqueue_link(rep=True)`` to the
     first keyframe: the facade's live global loop;
  3. the bare reprojection link alone (the ablation: it cannot pull the
     drift through the fine level's redescending loss).

The pose error is |local(truth, estimate)| (translation and rotation in
one 6-vector). Prints one JSON line. The JAX tool on a CPU reads 0.9712,
0.9712 and 0.0 (``LOOPS_r05.md``); ``tests/test_torch_loop_correction.py``
holds the port to those on the CPU.

Run from the repository root (on the GPU unless --device cpu):
    python3 port_tools/loop_correction_demo.py [--device cpu]
"""
import argparse
import copy
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

H, W, N_KF = 96, 128, 8


PATHS = ("archived_prior", "live_loop_prior_plus_rep",
         "bare_rep_link_ablation")


def run(device="cuda", drift_t=0.30, drift_yaw=0.10, ransac_draw=None,
        images=None, window_out=None):
    """The three corrections; returns {path: {pose_err_before,
    pose_err_after, removed_fraction, loop_rep_factors}}, the last the
    reprojection factors between the newest and the first keyframe as
    [src slot, dst slot, matches]. ``ransac_draw`` makes the mapper's
    RANSAC draw hook (default: the mapper's own); ``images`` = (frames,
    depths) replaces the rendered views (arrays [N, H, W]); a dict
    ``window_out`` gets the window's poses after the injection as "pose"
    (q | t, [K, 7])."""
    import numpy as np
    import torch

    from deepfactors_tpu_torch.geometry import se3 as se3m
    from deepfactors_tpu_torch.geometry.camera import PinholeCamera
    from deepfactors_tpu_torch.geometry.se3 import SE3
    from deepfactors_tpu_torch.io import synth
    from deepfactors_tpu_torch.mapping.mapper import Mapper, MapperConfig

    cam = PinholeCamera.create(fx=110.0, fy=110.0, u0=W / 2, v0=H / 2,
                               width=W, height=H)
    scene = synth.random_room(7, n_boxes=3)
    # 0.3pi: the loop pair (first and last) keeps the image overlap a
    # verified loop candidate has
    poses = synth.orbit_trajectory(N_KF, sweep=0.3 * np.pi)
    if images is None:
        frames, depths = synth.render_sequence(scene, cam, poses, H, W,
                                               with_depth=True, device=device)
    else:
        frames, depths = (torch.as_tensor(np.asarray(a), device=device)
                          for a in images)
    oracle = synth.OracleDecoder(frames, depths, levels=3, code_size=8)
    dev = torch.device(device)
    on = lambda p: SE3(torch.as_tensor(p.q, device=dev),
                       torch.as_tensor(p.t, device=dev))
    # the world frame is keyframe 0's camera frame
    gt = [se3m.mul(se3m.inverse(on(poses[0])), on(p)) for p in poses]

    def pose_err(m, slot, k):
        est = se3m.index(m.state.pose, slot)
        return float(torch.linalg.norm(se3m.local(gt[k], est)))

    def settle(m):
        while m.has_work():
            m.mapping_run()
        m.update_map()

    def build():
        cfg = MapperConfig(
            max_keyframes=8, max_frames=0, max_factors=32, code_size=8,
            height=H, width=W, pyramid_levels=3, pho_iters=(4, 8, 15),
            connection_mode="LASTN", max_back_connections=2,
            use_schur=False, use_reprojection=True)
        m = Mapper(cfg, cam, decoder=oracle, device=dev)
        if ransac_draw is not None:
            m.ransac_draw = ransac_draw()
        slots = []
        for k in range(N_KF):
            g = SE3(gt[k].q.cpu().numpy(), gt[k].t.cpu().numpy())
            slots.append(m.enqueue_keyframe(np.asarray(frames[k]), g))
            settle(m)
        # inject the drift into the newest keyframe
        s = slots[-1]
        dq = se3m.so3_exp_quat(torch.tensor([0.0, drift_yaw, 0.0],
                                            device=dev))
        m.state.pose.q[s] = se3m.quat_mul(dq, m.state.pose.q[s])
        m.state.pose.t[s] += torch.tensor([drift_t, 0.0, 0.0], device=dev)
        return m, slots

    def truth(k):
        return SE3(gt[k].q.cpu().numpy(), gt[k].t.cpu().numpy())

    # one window for the three paths (the JAX tool builds the same window
    # three times, from the same seed of its RANSAC draws)
    built, slots = build()
    if window_out is not None:
        window_out["pose"] = torch.cat(
            [built.state.pose.q, built.state.pose.t], dim=1).cpu().numpy()
    results = {}
    for path in PATHS:
        m = copy.deepcopy(built)
        last, k = slots[-1], N_KF - 1
        before = pose_err(m, last, k)
        if path != "bare_rep_link_ablation":
            m.add_loop_prior(last, truth(k), sigma=0.05)
            # the loop constraint needs the full C2F descent: fresh
            # photometric works on the newest back-connection, as the
            # facade's _apply_loop_correction adds
            m._add_photo_pair(last, slots[-2], second_removes=True)
        if path != "archived_prior":
            m.enqueue_link(last, slots[0], photo=False, rep=True)
        settle(m)
        after = pose_err(m, last, k)
        pool = m.rep_pool
        loop = [[int(pool.src[i]), int(pool.dst[i]), int(pool.mvalid[i].sum())]
                for i in np.nonzero(pool.active)[0]
                if {int(pool.src[i]), int(pool.dst[i])} == {last, slots[0]}]
        results[path] = {"pose_err_before": before, "pose_err_after": after,
                         "removed_fraction": 1.0 - after / before,
                         "loop_rep_factors": loop}
    return results


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--drift-t", type=float, default=0.30,
                    help="injected translation drift [m]")
    ap.add_argument("--drift-yaw", type=float, default=0.10,
                    help="injected yaw drift [rad]")
    args = ap.parse_args()
    out = {"injected_drift": {"t_m": args.drift_t, "yaw_rad": args.drift_yaw},
           "device": args.device}
    if args.device != "cpu":
        import subprocess
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
    out.update(run(args.device, args.drift_t, args.drift_yaw))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
