"""The bench's configuration in the port: bench.py's frame size, camera
and decoder, and ``tools/bench_e2e.py``'s ``build_system`` (reprojection
factors and loop closure on, the shipped vocabulary). ``chip_smoke.py``'s
phase 8 and ``profile_event`` build their systems here."""
from __future__ import annotations

import os

from ..geometry.camera import PinholeCamera

H, W, CS = 192, 256, 32
DECODER = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "data", "nets", "room256_32v4")


def bench_camera() -> PinholeCamera:
    return PinholeCamera.create(fx=220.0, fy=220.0, u0=W / 2, v0=H / 2,
                                width=W, height=H)


def load_bench_decoder(device="cuda"):
    """bench.py's decoder, room256_32v4 (``<DECODER>.json`` / ``.pkl``)."""
    from ..models.decoder import load_decoder

    return load_decoder(DECODER, device=device)


def bench_system(cam: PinholeCamera, decoder, dev, max_keyframes=10,
                 dist_threshold=2.0, pipeline_depth=1):
    """tools/bench_e2e.py's ``build_system`` at the camera's size:
    reprojection factors and loop closure on, the shipped vocabulary."""
    from ..loop.vocabulary import default_vocabulary
    from ..mapping.mapper import MapperConfig
    from ..system import DeepFactors, SystemConfig

    cfg = SystemConfig(
        mapper=MapperConfig(
            max_keyframes=max_keyframes, max_frames=2,
            max_factors=4 * max_keyframes, code_size=CS,
            height=int(cam.height), width=int(cam.width), pyramid_levels=3,
            pho_iters=(4, 8, 15), connection_mode="LASTN",
            max_back_connections=2, use_reprojection=True),
        dist_threshold=dist_threshold,
        tracking_dist_threshold=2.5 * dist_threshold,
        frame_dist_threshold=0.12, loop_closure=True, loop_active_window=8,
        loop_max_dist=0.35, pipeline_depth=pipeline_depth)
    return DeepFactors(cfg, cam, decoder=decoder,
                       vocabulary=default_vocabulary(device=dev), device=dev)
