"""The demo entry: run the SLAM system on a dataset source.

PyTorch port of the JAX package's ``df_demo.py`` (the reference's demo
binary, sources/demo/main.cpp and live_demo.cpp): a URL-scheme source
(``io/drivers.py``), a layered ``--flagfile`` configuration, the two-frame
bootstrap and the per-frame loop, a crash directory, and the results with
their provenance in a run directory (``flags.txt``, ``trajectory.txt``,
``keyframes.txt``, ``kf_<id>_img.png`` / ``kf_<id>_dpt.png``,
``intrinsics.txt``; with ``--dump_state=true`` also ``state.json``,
``factor_graph.dot`` and ``photo_errors.png``), and the ATE when the source
has ground truth.

Usage:
  python -m deepfactors_tpu_torch.demo --source synthetic://256x192:50 \\
      --log_dir runs/synthetic
  python -m deepfactors_tpu_torch.demo --source tum:///data/fr1_desk \\
      --flagfile data/flags/dataset_odom.flags \\
      --network_path data/nets/room256_32v4.json \\
      --network_weights data/nets/room256_32v4.pkl

Flags read here (the rest configure the system, ``config.py``): source,
log_dir (default ``df_run`` under the temp directory), frame_limit,
init_on_start, network_path, network_weights, use_decoder, code_size,
pyramid_levels, input_width, input_height, camera_distortion
(``k1,k2,p1,p2[,k3]``), dump_state, enable_timing, and ``--device``
(default ``cuda``; a card run that finds no CUDA device stops). The JAX
demo's compilation_cache / compilation_cache_dir are accepted and do
nothing (nothing is compiled ahead here).

Two departures from ``df_demo.py``, both repairs:
  - each frame is preprocessed once: ``df_demo.py`` passes the
    preprocessed frame to ``process_frame``, which preprocesses again, so
    that a remapped source is remapped twice;
  - the decoder's architecture (``base_ch``, ``pred_head``) is read from
    the network's JSON by the port's ``config.load_network_config``: the
    JAX package's drops it, so ``df_demo.py`` builds a "gap" head for a
    network trained with a "conv" one (room256_32v2 and later) and fails to
    load it.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
import time
import traceback

import torch


def _network_config(flags: dict):
    """The decoder's NetworkConfig from ``--network_path`` or from the
    flags."""
    from . import config as cfgm
    from .models.decoder import NetworkConfig

    if "network_path" in flags:
        return cfgm.load_network_config(flags["network_path"])
    return NetworkConfig(
        code_size=int(flags.get("code_size", 32)),
        pyramid_levels=int(flags.get("pyramid_levels", 3)),
        input_width=int(flags.get("input_width", 256)),
        input_height=int(flags.get("input_height", 192)))


def _flag_true(flags: dict, key: str, default: str) -> bool:
    return flags.get(key, default).lower() == "true"


def run(argv, on_system=None, log=print):
    """Run the demo on ``argv`` (the JAX demo's flags, plus ``--device``).
    ``on_system(df)`` is called with the system before the first frame.
    Returns (system, summary): the summary holds the frames processed,
    seconds, keyframes live and built, frames lost, the tracked fraction,
    the ATE (None without ground truth), the run directory and the files
    written there."""
    from . import config as cfgm
    from .geometry.camera import PinholeCamera
    from .io import drivers
    from .io.preprocess import SourceCamera
    from .loop.vocabulary import default_vocabulary
    from .models.decoder import Decoder, load_params
    from .system import DeepFactors
    from .utils import tum_io
    from .utils.timing import enable_timing, reset_timing, timing_summary

    flags = cfgm.parse_args(list(argv))
    device = torch.device(flags.pop("device", "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    source = flags.get("source", "synthetic://256x192:30")
    log_dir = flags.get("log_dir", os.path.join(tempfile.gettempdir(),
                                                "df_run"))
    init_on_start = flags.get("init_on_start", "true").lower() != "false"
    frame_limit = int(flags.get("frame_limit", 0))
    timing = _flag_true(flags, "enable_timing", "false")
    if timing:
        reset_timing()
        enable_timing(True)

    cam_iface = drivers.get_interface_from_url(source, device=device)
    fx, fy, u0, v0, W0, H0 = cam_iface.intrinsics()

    # the image is remapped to the network's trained resolution
    # (deepfactors.cpp:634-680)
    netcfg = _network_config(flags)
    H, W = netcfg.input_height, netcfg.input_width
    if netcfg.fx > 0:
        # the network was trained at specific intrinsics: remap every frame
        # to them (deepfactors.cpp:634-646)
        cam = PinholeCamera.create(fx=netcfg.fx, fy=netcfg.fy, u0=netcfg.u0,
                                   v0=netcfg.v0, width=W, height=H)
    else:
        sx, sy = W / W0, H / H0
        cam = PinholeCamera.create(fx=fx * sx, fy=fy * sy, u0=u0 * sx,
                                   v0=v0 * sy, width=W, height=H)
    sys_cfg = cfgm.build_system_config(flags, H, W)

    decoder = None
    if _flag_true(flags, "use_decoder", "true"):
        wpath = flags.get("network_weights")
        params = load_params(wpath) if wpath and os.path.exists(wpath) \
            else None
        decoder = Decoder(netcfg._replace(
            pyramid_levels=sys_cfg.mapper.pyramid_levels,
            code_size=sys_cfg.mapper.code_size), params=params, device=device)
    df = DeepFactors(sys_cfg, cam, decoder=decoder,
                     vocabulary=default_vocabulary(device=device),
                     device=device)
    src_sig = (float(fx), float(fy), float(u0), float(v0), int(W0), int(H0))
    net_sig = (float(cam.fx), float(cam.fy), float(cam.u0), float(cam.v0),
               int(W), int(H))
    if src_sig != net_sig:
        dist = None
        if "camera_distortion" in flags:
            dist = [float(x) for x in flags["camera_distortion"].split(",")]
        df.set_source_camera(SourceCamera(fx, fy, u0, v0, W0, H0, dist))

    os.makedirs(log_dir, exist_ok=True)
    cfgm.save_run_flags(log_dir, flags)
    if on_system is not None:
        on_system(df)
    log(f"source: {source}  net: {W}x{H} CS={sys_cfg.mapper.code_size} "
        f"levels={sys_cfg.mapper.pyramid_levels}  device: {device}")

    t_start = time.perf_counter()
    n_frames = 0
    prev = None
    gt_by_ts = {}
    try:
        for fd in cam_iface.frames():
            if fd.gt_pose is not None:
                gt_by_ts[fd.timestamp] = fd.gt_pose
            if not df.bootstrapped:
                img = df.preprocess_image(fd.img)
                if prev is None:
                    prev = img
                    continue
                if init_on_start:
                    df.bootstrap_two_frames(prev, img)
                    log("bootstrapped (two frames)")
                continue
            df.process_frame(fd.timestamp, fd.img)
            n_frames += 1
            if n_frames % 10 == 0:
                dt = time.perf_counter() - t_start
                log(f"frame {n_frames}: {n_frames / dt:.1f} fps, "
                    f"kfs={len(df.mapper.kf_slots)} "
                    f"inliers={df.stats.inliers:.2f} "
                    f"lost={df.tracking_lost}")
            if frame_limit and n_frames >= frame_limit:
                break
        df.flush()
    except Exception:
        # post-crash state save (deepfactors.cpp:493-537, live_demo crash
        # marker :398-413)
        traceback.print_exc()
        crash_dir = os.path.join(log_dir, "crash")
        os.makedirs(crash_dir, exist_ok=True)
        with open(os.path.join(crash_dir, "crash"), "w") as f:
            f.write(traceback.format_exc())
        try:
            df.save_results(crash_dir)
        except Exception:
            traceback.print_exc()
        raise

    df.save_results(log_dir)
    if _flag_true(flags, "dump_state", "false"):
        # observability dumps (mapper.cpp:569-632 SaveGraphs/PrintWork and
        # :647-795 error-image mosaics)
        from . import viz

        with open(os.path.join(log_dir, "state.json"), "w") as f:
            json.dump(df.mapper.dump_state(verbose_errors=True), f, indent=1)
        df.mapper.save_graphs(os.path.join(log_dir, "factor_graph.dot"))
        viz.export_error_mosaics(os.path.join(log_dir, "photo_errors.png"),
                                 df.mapper, cam)
        log(f"state dumps -> {log_dir}")
    dt = time.perf_counter() - t_start
    log(f"done: {n_frames} frames in {dt:.1f}s "
        f"({n_frames / max(dt, 1e-9):.1f} fps), "
        f"{len(df.mapper.kf_slots)} keyframes -> {log_dir}")

    ate = None
    if cam_iface.has_ground_truth:
        pairs = [(ts, p) for ts, p in df.trajectory if ts in gt_by_ts]
        if len(pairs) >= 3:
            ate = tum_io.ate_rmse(pairs, [(ts, gt_by_ts[ts])
                                          for ts, _ in pairs])
            log(f"ATE RMSE: {ate:.4f} m")
    if timing:
        enable_timing(False)
        for k, v in timing_summary().items():
            dev = (f"; device {v['dev_ms']:.2f} ms, self "
                   f"{v['dev_self_ms']:.2f}" if "dev_ms" in v else "")
            log(f"[timing] {k}: x{v['count']}, host {v['host_ms']:.2f} ms, "
                f"self {v['host_self_ms']:.2f}{dev}")
    summary = dict(
        frames=n_frames, seconds=dt, keyframes=len(df.mapper.kf_slots),
        keyframes_built=df.mapper._next_kid, lost=df.n_lost_frames,
        tracked=1.0 - df.n_lost_frames / max(df.n_frames, 1), ate=ate,
        log_dir=log_dir, files=sorted(os.listdir(log_dir)))
    return df, summary


def main(argv) -> int:
    """Run the demo and print as ``df_demo.py`` does."""
    run(argv, log=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
