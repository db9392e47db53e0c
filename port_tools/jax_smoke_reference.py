"""Reference run of the JAX facade on the end-to-end configurations that
``chip_smoke.py`` drives through the PyTorch port.

Same scene, trajectory, pacing and system configuration as chip_smoke.py's
end-to-end phases: ``random_room(seed, n_boxes=3)`` (``--scene-seed``, 7
unless given), the first ``--frames`` poses of
``orbit_trajectory(300, sweep=3.2*pi)`` rendered at 192x256, the
``room256_32v4`` decoder, bootstrap on frames 0 and 2, sequential facade
with loop closure off and reprojection factors off unless
``--use-reprojection`` is given (the mapper's default configuration), and
loop closure off unless ``--loop-closure`` is given (with the shipped
vocabulary ``default_vocabulary()``; ``tools/bench_e2e.py``'s flagship
configuration adds ``--loop-active-window 8 --loop-max-dist 0.35``). The
accuracy numbers it prints (tracked fraction, rigid ATE, keyframe and
eviction counts, the first lost frame, the loop counters, the
relocalisations and every accepted loop with its frame) are the parity
target and the source of the ATE bounds chip_smoke.py asserts.

Run on the CPU, from the repository root:
  the 60-frame run in a window of 32 (no eviction):
    JAX_PLATFORMS=cpu python port_tools/jax_smoke_reference.py
  the long run that outlives the default window of 16 (in room 5: in
  room 7 this facade loses tracking at frame 126):
    JAX_PLATFORMS=cpu python port_tools/jax_smoke_reference.py \
        --frames 180 --max-keyframes 16 --max-factors 64 --scene-seed 5
  either with the reprojection factors on: add --use-reprojection.
  the flagship configuration (chip_smoke.py's loop-closure phase):
    JAX_PLATFORMS=cpu python port_tools/jax_smoke_reference.py \
        --use-reprojection --loop-closure --loop-active-window 8 \
        --loop-max-dist 0.35 --frames 186 --scene-seed 42
the bench's own row (``bench.py``'s ``bench_e2e(..., pipeline_depth=1)``,
chip_smoke.py's pipelined phase): ``--bench-sequence`` renders
``orbit_trajectory(--frames)`` with its default sweep of 2.6*pi (300
frames unless given), builds ``tools/bench_e2e.build_system(...,
max_keyframes=10, dist_threshold=2.0, loop_closure=True,
use_reprojection=True, pipeline_depth=--pipeline-depth)``, calls
``prewarm()``, bootstraps on frames 0 and 2 (``frame_gap=2``), feeds 10
warm frames, ``flush()``, the rest, and ``flush()`` again:
    JAX_PLATFORMS=cpu python port_tools/jax_smoke_reference.py \
        --bench-sequence --pipeline-depth 1 --scene-seed 7
the reference's refinement configuration (chip_smoke.py's phase 9):
``--flagfile FILE`` builds the system with ``config.build_system_config``
from ``config.parse_args(["--flagfile=FILE"] + overrides)`` at 192x256
instead of the settings above (loop closure, reprojection and geometric
factors, windows and thresholds all come from the flags; the shipped
vocabulary when the flags turn loop closure on), each ``--set KEY=VALUE``
an override as on the command line, with one change: the geometric pool
holds ``max_keyframes * max_back_connections + 16`` factors (the rep
pool's worst-case rule), since the flags' default of 16 is exhausted at
the fifth keyframe event with four back-connections:
    JAX_PLATFORMS=cpu python port_tools/jax_smoke_reference.py \
        --flagfile data/flags/alg_refine.flags \
        --set tracking_dist_threshold=5.0 --frames 100 --scene-seed 7
the depth prior (chip_smoke.py's phase 9b): ``--depth-prior`` runs the
scenario of tests/test_mapper.py:174 (two keyframes of one image at the
identity with a flat synthetic decode, prx = 0.5 + 0.1 code[0], CS 2,
2 levels, both tied to a depth of 2.5 m) at 192x256: mapped until the work
queue drains, and for one GN iteration (``depth_prior_reference``); it
prints the decoded level-0 depth's mean absolute error to the target
before and after each, the steps, the code and the one iteration's fall:
    JAX_PLATFORMS=cpu python port_tools/jax_smoke_reference.py --depth-prior
``--pipeline-depth N`` (0 unless given) runs any of the above pipelined,
with a ``flush()`` after the last frame.
``--trace FILE`` writes the per-frame decision trace of
``port_tools/decision_trace.py`` (compare it with the port's from
``port_tools/facade_run.py --trace``). Prints one JSON line. Its wall-clock numbers are CPU numbers and say
nothing about any accelerator.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

SEQ_LEN = 300
WARM = 10        # the bench row's warm frames before its first flush()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=None,
                    help="frames of the orbit (60; 300 with --bench-sequence)")
    ap.add_argument("--max-keyframes", type=int, default=32)
    ap.add_argument("--max-factors", type=int, default=128)
    ap.add_argument("--scene-seed", type=int, default=7)
    # the one-way-frame policy's distance (0.12 in every configuration of
    # chip_smoke.py); other values probe how far a run depends on one
    # decision falling a frame earlier or later
    ap.add_argument("--frame-dist-threshold", type=float, default=0.12)
    ap.add_argument("--use-reprojection", action="store_true")
    ap.add_argument("--loop-closure", action="store_true")
    ap.add_argument("--loop-active-window", type=int, default=10)
    ap.add_argument("--loop-max-dist", type=float, default=0.5)
    ap.add_argument("--trace", default=None,
                    help="write the per-frame decision trace here")
    ap.add_argument("--pipeline-depth", type=int, default=0)
    ap.add_argument("--bench-sequence", action="store_true",
                    help="bench.py's end-to-end row (see the docstring)")
    ap.add_argument("--ransac-seed", type=int, default=None,
                    help="seed of the mapper's RANSAC key chain (its own: "
                         "42); how far a run depends on RANSAC's draws")
    ap.add_argument("--flagfile", default=None,
                    help="build the system from this flag file (see the "
                         "docstring)")
    ap.add_argument("--set", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="a flag override after --flagfile, as on the "
                         "command line")
    ap.add_argument("--depth-prior", action="store_true",
                    help="the depth-prior scenario (see the docstring)")
    ap.add_argument("--stop", type=int, default=None,
                    help="feed frames up to stop - 1 only (the orbit's "
                         "pacing stays that of --frames)")
    args = ap.parse_args()
    if args.depth_prior:
        print(json.dumps(depth_prior_reference(192, 256)))
        return
    n_frames = args.frames or (300 if args.bench_sequence else 60)

    from deepfactors_tpu.geometry.camera import PinholeCamera
    from deepfactors_tpu.io import synth
    from deepfactors_tpu.loop.vocabulary import default_vocabulary
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

    scene = synth.random_room(args.scene_seed, n_boxes=3)
    if args.bench_sequence:
        poses = synth.orbit_trajectory(n_frames)
    else:
        poses = synth.orbit_trajectory(SEQ_LEN, sweep=3.2 * np.pi)[:n_frames]
    frames = synth.render_sequence(scene, cam, poses, H, W)

    if args.bench_sequence:
        from tools.bench_e2e import build_system

        df = build_system(cam, H, W, decoder, max_keyframes=10,
                          dist_threshold=2.0, loop_closure=True,
                          use_reprojection=True,
                          pipeline_depth=args.pipeline_depth)
        args.use_reprojection = args.loop_closure = True
    else:
        df = None
    cfg = SystemConfig(
        mapper=MapperConfig(
            max_keyframes=args.max_keyframes, max_frames=2,
            max_factors=args.max_factors, code_size=32,
            height=H, width=W, pyramid_levels=3, pho_iters=(4, 8, 15),
            connection_mode="LASTN", max_back_connections=2,
            use_reprojection=args.use_reprojection),
        dist_threshold=2.0, tracking_dist_threshold=5.0,
        frame_dist_threshold=args.frame_dist_threshold,
        loop_closure=args.loop_closure,
        loop_active_window=args.loop_active_window,
        loop_max_dist=args.loop_max_dist,
        pipeline_depth=args.pipeline_depth)
    if args.flagfile:
        from deepfactors_tpu.config import build_system_config, parse_args

        cfg = build_system_config(parse_args(
            [f"--flagfile={args.flagfile}"] + [f"--{kv}" for kv in args.set]),
            H, W)
        mc = cfg.mapper
        cfg = cfg._replace(mapper=mc._replace(
            max_geo_factors=mc.max_keyframes * mc.max_back_connections + 16),
            pipeline_depth=args.pipeline_depth)
        args.loop_closure = cfg.loop_closure
        args.use_reprojection = cfg.mapper.use_reprojection
    if df is None:
        df = DeepFactors(cfg, cam, decoder=decoder,
                         vocabulary=default_vocabulary() if args.loop_closure
                         else None)
    # every dense verification of a global-loop candidate set: the frame,
    # the candidates' similarities, verified inlier shares and translations
    verifications = []
    if args.loop_closure:
        ld = df.loop_detector
        verify = ld._verify
        frame_no = [0]

        def logged_verify(*a):
            out = verify(*a)
            pk = np.asarray(out)
            verifications.append(dict(
                frame=frame_no[0],
                inliers=[round(float(x), 4) for x in pk[:, 7]],
                t_norm=[round(float(x), 4)
                        for x in np.linalg.norm(pk[:, 4:7], axis=-1)]))
            return out

        ld._verify = logged_verify
    if args.ransac_seed is not None:
        df.mapper._rng_key = jax.random.PRNGKey(args.ransac_seed)
    loops = []
    prewarm_s = None
    if args.bench_sequence:
        t0 = time.perf_counter()
        df.prewarm()
        prewarm_s = time.perf_counter() - t0
    # frames fed -> keyframes built so far (a pipelined facade builds a
    # frame's keyframe when it retires it, depth frames later)
    kf_at = []
    t0 = time.perf_counter()
    df.bootstrap_two_frames(frames[0], frames[2], frame_gap=2)
    close_trace = None
    if args.trace:
        import decision_trace
        close_trace = decision_trace.attach(df, args.trace)
    df.trajectory = [(0.0, df.pose_wc)]
    first_lost = None
    ate_at = {}
    stop = args.stop or n_frames
    for i in range(3, stop):
        if args.loop_closure:
            frame_no[0] = i
        n_loops = len(df.loop_links)
        n_reloc = df.n_relocalizations
        n_kid = df.mapper._next_kid
        df.process_frame(float(i), frames[i])
        if args.bench_sequence and i == 2 + WARM:
            df.flush()
        if i == stop - 1:
            df.flush()
        if df.mapper._next_kid > n_kid:
            kf_at.append(i)
        for link in df.loop_links[n_loops:]:
            loops.append([i, str(link)])
        if df.n_relocalizations > n_reloc:
            loops.append([i, "relocalisation"])
        if first_lost is None and df.n_lost_frames > 0:
            first_lost = i
        if first_lost is None and (i + 1) % 20 == 0:
            est = df.trajectory
            ate_at[i + 1] = [tum_io.ate_rmse(
                est, [(ts, poses[int(ts)]) for ts, _ in est]),
                len(df.mapper.archived)]
    wall = time.perf_counter() - t0
    if close_trace is not None:
        close_trace()

    est = df.trajectory
    gt = [(ts, poses[int(ts)]) for ts, _ in est]
    print(json.dumps({
        "ate_m": tum_io.ate_rmse(est, gt),
        "tracked_fraction": 1.0 - df.n_lost_frames / max(df.n_frames, 1),
        "n_lost_frames": df.n_lost_frames,
        "n_keyframes": len(df.mapper.kf_slots),
        "n_evictions": len(df.mapper.archived),
        "first_lost_frame": first_lost,
        # frames fed so far -> [rigid ATE (m), evictions], while none is lost
        "ate_and_evictions_at": ate_at,
        "n_frames_processed": df.n_frames,
        "trajectory_len": len(est),
        "pending_after_flush": len(df._pending),
        "pipeline_depth": args.pipeline_depth,
        "bench_sequence": args.bench_sequence,
        "ransac_seed": args.ransac_seed,
        "scene_seed": args.scene_seed,
        "n_keyframes_built": df.mapper._next_kid,
        # frames fed at which a keyframe was built (retired)
        "keyframe_frames": kf_at,
        "use_reprojection": args.use_reprojection,
        "loop_closure": args.loop_closure,
        "n_local_links": df.n_local_links,
        "n_live_global_loops": df.n_live_global_loops,
        "n_archived_loops": df.n_archived_loops,
        "n_relocalizations": df.n_relocalizations,
        # [frame, loop link or "relocalisation"] in order
        "loop_events": loops,
        "verifications": verifications,
        "n_rep_factors_live": int(df.mapper.rep_pool.active.sum())
        if args.use_reprojection else 0,
        "flagfile": args.flagfile,
        "flag_overrides": args.set,
        "use_geometric": df.cfg.mapper.use_geometric,
        "n_geo_factors_live": int(df.mapper.geo_pool.active.sum())
        if df.cfg.mapper.use_geometric else 0,
        "cpu_wall_s": wall,
        "cpu_prewarm_s": prewarm_s,
        "platform": jax.devices()[0].platform,
    }))


def depth_prior_reference(H, W):
    """tests/test_mapper.py:174's scenario at H x W, twice: mapped until the
    work queue drains (the mean absolute error of keyframe 0's decoded
    level-0 depth to the prior's target before and after, the mapping
    steps, the codes), and with pho_iters (0, 0), so that each mapping step
    is one GN iteration: the error after the first one and the ratio of the
    error before to it (mapped to the end, the error falls to fp32
    round-off, 0 to 5e-7, whose ratio measures nothing)."""
    full = _depth_prior_run(H, W, (6, 6))
    one = _depth_prior_run(H, W, (0, 0), max_steps=1)
    return dict(height=H, width=W, err_before=full["before"],
                err_after=full["after"], steps=full["steps"],
                code=full["code"], err_after_one_iteration=one["after"],
                factor_one_iteration=one["before"] / one["after"])


def _depth_prior_run(H, W, pho_iters, max_steps=None):
    import jax.numpy as jnp

    from deepfactors_tpu.geometry import se3 as se3m
    from deepfactors_tpu.geometry.camera import PinholeCamera
    from deepfactors_tpu.mapping.mapper import Mapper, MapperConfig
    from deepfactors_tpu.ops import image as ip

    target_dpt, CS2 = 2.5, 2
    cfg = MapperConfig(
        max_keyframes=2, max_frames=1, max_factors=4, code_size=CS2,
        height=H, width=W, pyramid_levels=2, pho_iters=pho_iters,
        huber_delta=0.3, connection_mode="LASTN", max_back_connections=1,
        lm_lambda=1e-4, use_schur=False, use_depth_prior=True,
        dpt_prior_sigma=0.05, code_prior=100.0)
    cam = PinholeCamera.create(fx=60.0, fy=60.0, u0=W / 2, v0=H / 2,
                               width=W, height=H)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    img = jnp.asarray(0.5 + 0.2 * np.sin(xs / 5) * np.cos(ys / 4))
    m = Mapper(cfg, cam, decoder=None)
    img_pyr = ip.build_pyramid(img, 2)
    grad_pyr = ip.build_gradient_pyramid(img_pyr)
    prx0 = tuple(jnp.full_like(im, 0.5) for im in img_pyr)
    jac = tuple(jnp.stack([jnp.full_like(im, 0.1), jnp.zeros_like(im)],
                          axis=-1) for im in img_pyr)
    stdev = tuple(jnp.zeros_like(im) for im in img_pyr)
    pyramids = (img_pyr, grad_pyr, prx0, jac, stdev,
                jnp.zeros((CS2,), jnp.float32), None)
    p0 = se3m.identity()
    s0 = m.add_keyframe_to_map(img, p0, pyramids=pyramids)
    s1 = m.add_keyframe_to_map(img, p0, pyramids=pyramids)
    m._anchor_pose = p0
    m._add_photo_pair(s0, s1)
    target = np.full((H, W), target_dpt, np.float32)
    m.set_depth_prior(s0, target)
    m.set_depth_prior(s1, target)
    err = lambda: float(np.mean(np.abs(np.asarray(m.state.levels[0].dpt[s0])
                                       - target)))
    before = err()
    steps = 0
    while m.has_work() and (max_steps is None or steps < max_steps):
        m.mapping_step()
        steps += 1
    m.update_map()
    return dict(before=before, after=err(), steps=steps,
                code=np.asarray(m.state.code).tolist())


if __name__ == "__main__":
    main()
