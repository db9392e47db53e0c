"""Reference run of the JAX facade on the end-to-end configuration that
``chip_smoke.py`` drives through the PyTorch port.

Same scene, trajectory, pacing and system configuration as chip_smoke.py's
end-to-end phase: ``random_room(7, n_boxes=3)``, the first 60 poses of
``orbit_trajectory(300, sweep=3.2*pi)`` rendered at 192x256, the
``room256_32v4`` decoder, bootstrap on frames 0 and 2, sequential facade
with loop closure and reprojection factors off. The accuracy numbers it
prints (tracked fraction, rigid ATE, keyframe count) are the parity target
and the source of the ATE bound chip_smoke.py asserts.

Run on the CPU:  JAX_PLATFORMS=cpu python port_tools/jax_smoke_reference.py
Prints one JSON line. Its wall-clock numbers are CPU numbers and say
nothing about any accelerator.
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

N_FRAMES = 60
SEQ_LEN = 300


def main():
    from deepfactors_tpu.geometry.camera import PinholeCamera
    from deepfactors_tpu.io import synth
    from deepfactors_tpu.mapping.mapper import MapperConfig
    from deepfactors_tpu.models.decoder import (Decoder, NetworkConfig,
                                                load_params)
    from deepfactors_tpu.system import DeepFactors, SystemConfig
    from deepfactors_tpu.utils import tum_io

    H, W = 192, 256
    cam = PinholeCamera.create(fx=220.0, fy=220.0, u0=W / 2, v0=H / 2,
                               width=W, height=H)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    prefix = os.path.join(root, "data", "nets", "room256_32v4")
    with open(prefix + ".json") as f:
        nj = json.load(f)
    ncfg = NetworkConfig(
        code_size=nj["code_size"], pyramid_levels=nj["pyramid_levels"],
        input_width=nj["input_width"], input_height=nj["input_height"],
        avg_dpt=nj["avg_dpt"], base_ch=nj.get("base_ch", 32),
        pred_head=nj.get("pred_head", "gap"))
    decoder = Decoder(ncfg, params=load_params(prefix + ".pkl"))

    scene = synth.random_room(7, n_boxes=3)
    poses = synth.orbit_trajectory(SEQ_LEN, sweep=3.2 * np.pi)[:N_FRAMES]
    frames = synth.render_sequence(scene, cam, poses, H, W)

    cfg = SystemConfig(
        mapper=MapperConfig(
            max_keyframes=32, max_frames=2, max_factors=128, code_size=32,
            height=H, width=W, pyramid_levels=3, pho_iters=(4, 8, 15),
            connection_mode="LASTN", max_back_connections=2,
            use_reprojection=False),
        dist_threshold=2.0, tracking_dist_threshold=5.0,
        frame_dist_threshold=0.12, loop_closure=False)
    df = DeepFactors(cfg, cam, decoder=decoder)
    t0 = time.perf_counter()
    df.bootstrap_two_frames(frames[0], frames[2], frame_gap=2)
    df.trajectory = [(0.0, df.pose_wc)]
    for i in range(3, N_FRAMES):
        df.process_frame(float(i), frames[i])
    wall = time.perf_counter() - t0

    est = df.trajectory
    gt = [(ts, poses[int(ts)]) for ts, _ in est]
    print(json.dumps({
        "ate_m": tum_io.ate_rmse(est, gt),
        "tracked_fraction": 1.0 - df.n_lost_frames / max(df.n_frames, 1),
        "n_lost_frames": df.n_lost_frames,
        "n_keyframes": len(df.mapper.kf_slots),
        "n_frames_processed": df.n_frames,
        "cpu_wall_s": wall,
        "platform": jax.devices()[0].platform,
    }))


if __name__ == "__main__":
    main()
